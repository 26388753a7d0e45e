#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit::

    python3 chip_smoke.py                 # every phase (one card)
    python3 chip_smoke.py --distributed   # phases 13-14 (four cards: 14 b)
    python3 chip_smoke.py --static        # phase 15
    python3 chip_smoke.py --recurrent     # phase 16
    python3 chip_smoke.py --vision        # phase 17
    python3 chip_smoke.py --zoo           # phase 18 (four cards: 18 b NCCL)

It imports only ``paddle_tpu_torch`` (never JAX or ``paddle_tpu``) and,
in order:

1. requires a CUDA device (exits 2 otherwise), turns TF32 off and prints
   the card's name and power limit as ``nvidia-smi`` reports them;
2. builds every CUDA kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one process per source, all at once), and beside them
   the serving transport's library from the repository's ``csrc/*.cc``
   with ``g++``, and prints the build times and ptxas report;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes its paths give it, within ``TOL`` (layer norm at the
   serving shapes and at training's [4096, 768] with eps 1e-5 and
   1e-12, at 45 and 770 columns (scalar loads) and at [64, 4096] (a row
   above the register cap), bitwise equal run to run, with the launch
   floor (an empty kernel under the same timer); paged attention, the
   single-query kernel also against its split-KV decomposition on lens
   at its chunk edges, bitwise equal run to run, and timed at the
   engine's decode lens too) or ``VERIFY_TOL`` (the multi-query verify
   kernel against its plain version and its split-KV decomposition at
   the main shape, on windows straddling chunk edges, at Qmax 9 and at
   the engine's own verify shape, timed there too; bitwise equal run to
   run, the merge tickets left zero, Qmax 1 bit-identical to the
   single-query kernel) or
   ``FLASH_TOL``/``FLASH_GRAD_TOL`` (flash
   attention, forward and both backward routes, with and without
   dropout, key bias, causal masking, ragged lengths and head dims 16 to
   512, D = 40 and 320 through the wrapper's zero padding, D = 640 and
   1024 as head-dim slices; the forward, dq and dK/dV bitwise equal run
   to run, and the fused backward on every fused-route case;
   ``flash_attention_with_lse`` on both backward routes with both
   cotangents, through its router on a path of its own, launches
   counted) or
   ``XENT_TOL``/``XENT_GRAD_TOL`` (the fused softmax cross-entropy's
   forward and its chunked backward, dlog + dW/db + dh, at BERT-base's
   MLM head and at ragged shapes: H = 1600, H = 45, V not a multiple of
   the chunk, a chunk wider than V, every row ignored; the backward also
   against its chunked plain version, bitwise equal run to run and with
   one gradient asked for; the forward bitwise equal run to run),
   and the Adam kernel bitwise (both variants on BERT-base's own leaves,
   AdamW's decay, the skip guard false), and times the kernel, the
   plain version, one PyTorch library call computing the same function
   (a yardstick the port never calls) and the card's bound for the work;
   the LayerNorm backward (plain PyTorch) is checked and timed too,
   with the kernel's forward through its autograd Function; bf16
   operands go through each wrapper's cast path (LayerNorm, also fp16;
   flash attention on both backward routes; the fused xent) against the
   plain version on the same bf16 inputs within ``BF16_TOL``, every
   output and gradient in the JAX package's dtype; then
   (``check_pinned_capture``) the captured steps' side stream is none of
   64 default-priority pool streams, and a fused Adam leaf table built
   on it, whose frame is held past its return and let go inside a
   capture on that stream (as a stack sampler or a garbage collection
   lets go), leaves pinned allocation working;
4. trains BERT-base (``BertConfig()``, random weights from a seed, fp32)
   through ``TrainStep`` with ``AdamW(1e-4, weight_decay=0.01)``, 5 steps
   per run (``TRAIN_RUNS``): batch 8, seq 512 (flash forward + the dq and
   dkv kernels); batch 32, seq 128 with ``flash_attention_min_seq_train``
   at 128 (flash forward + the fused backward kernel); batch 8, seq 512
   with ``fused_softmax_xent`` and ``fused_adam`` (plus the xent forward,
   the three backward kernels once per vocabulary chunk and the leaf Adam
   kernel; peak memory at most ``FUSED_PEAK_GB``); batch 32, seq 128 with
   ``use_pallas_adam`` (plus the flat Adam kernel). Every loss must be
   finite and each step must launch exactly the kernels its path needs
   (``expected_launches``); then profiles one default and one fused
   seq-512 step with ``torch.profiler``. Each run is done twice from the
   same weights, seed and batches: eager (``compiled=False``), then as
   ``TrainStep``'s captured step (``<run>_captured``: the first step
   eager, then one CUDA graph, replayed for every later step), whose
   launch counts (the graph's, added at each replay) must be the same,
   whose every loss and parameter must equal the eager run's
   (``captured_against_eager``: bit for bit, or within the
   card-against-CPU limits), and which is profiled (step ms, busy
   share, host launch calls, capture ms, peak allocated and reserved
   memory);
5. runs a 2-layer full-width BERT (dropout 0, batch 2, seq 512) on the
   card and the same model on the CPU (plain versions), under the default
   flags and again with ``fused_softmax_xent`` and ``fused_adam``: one
   forward and backward, comparing the loss and every parameter's
   gradient, then one ``TrainStep``, comparing the loss and every
   updated parameter (the host CPU's model, thread count and vector
   instruction set printed; under the default flags a third side runs
   the same model in float64 on the CPU, and each fp32 side's gradient
   gap to it is reported per leaf); then BERT-base in bf16 as the JAX
   bench builds it (``BF16_RUNS``: ``cast_model_to_low_precision(model, "bfloat16")``,
   ``AdamW(1e-4, weight_decay=0.01, fused_state=...)``), b8 x s512, 5
   steps under the default flags per leaf and 5 with the fused flags over
   the flat fused state: finite losses, exact launch counts, every
   parameter bf16 and every master and moment fp32, the fused run
   profiled; the 2-layer BERT in bf16 with a padded row, card against
   CPU, under both flag sets (``BF16_*`` tolerances); an fp16
   ``TrainStep(amp_dtype="float16", scaler=GradScaler())`` fed a poisoned
   batch twice (nothing changes, the scale halves, no host sync in the
   step) and then clean steps until one applies, eager and captured (the
   poisoned and clean steps checked are replays); ``run_steps`` over three
   stacked batches against three calls, bit for bit, eager and captured,
   and an ``EvalStep`` forward; the captured step against the eager one
   under a host-driven ``ReduceOnPlateau`` whose rate changes between two
   replays, and a second batch shape, which must capture a second
   graph;
5c. feeds, checkpoints, resumes and evaluates BERT (b8 x s512, 72
   masked positions a row as the JAX bench feeds it, dropout 0.1,
   captured steps; ``RESUME_*``): BERT-base in bf16 with the fused flags
   over the flat fused state fed for 8 steps from ``DataLoader`` with 2
   worker processes through a pinned ``DeviceLoader``, against the same
   step on the same batches made on the card beforehand (the same
   losses bit for bit; loader wait, step ms and busy share beside each
   other); the same model trained 8 steps uninterrupted, and again
   stopped after 4, saved with ``io.AsyncCheckpointer`` (host_state
   included), step 5 run at once while the writer works, a new epoch's
   workers forked (``iter_from(4)``), the step-4 checkpoint restored in
   place into the live captured step and step 5 replayed by its graph
   (no new capture; its loss and every leaf bit for bit the
   uninterrupted run's after step 5), everything dropped and built
   afresh, ``restore_latest`` + ``TrainStep.set_state_dict``, 4 more
   steps: losses 5-8 and every leaf of the training state (parameters,
   fp32 masters, moments, step counter, generator) bit for bit the
   uninterrupted run's, the checkpoint bit for bit the state at step 4
   (a torn save shows there), ``verify`` clean; the same at 2 layers in
   fp32 under the default flags; then the bf16 BERT-base eval forward
   through the captured ``EvalStep`` against the eager one, bit for bit,
   both timed, and a metric that synchronises with the host refused by
   name;
6. serves 16 requests through ``LLMEngine`` at GPT-2-small width (random
   weights from a seed; half of the requests join mid-decode) and holds
   every token against the port's dense ``generate()``; repeats four
   requests with speculative decoding (self-draft) and requires the same
   tokens and an accept rate of 1.0; then serves those four at
   temperature 0.8, plain and speculative, and requires the same sampled
   tokens and an accept rate of 1.0 again;
6b. serves the same model over TCP: two ``inference.Server`` backends
   (an ``LLMEngine`` each, self-draft, 1024-block pools) behind a
   ``Router`` with probes on (``WIRE``). The 16 requests go through the
   router from 4 client threads with ``Client.generate_stream`` and are
   held against phase 6's in-process tokens; the router's added latency
   is the same 4 requests one at a time direct to a backend and then
   through it; 4 speculative streams (k = 3) are held against the plain
   tokens with every draft token accepted; 4 streams at temperature 0.8,
   placed on one backend by prefix affinity, lose it after
   ``WIRE_FAILOVER_AFTER`` tokens (the backend is stopped) and must each
   equal an uninterrupted in-process run bit for bit (4 failovers).
   Around each of the three runs the launch counts must equal the
   engines' forwards times 25 LN and 12 paged (or verify) launches;
   any negative terminal frame, short stream, port left bound or thread
   left running fails the run. Client-side tokens/s, TTFT p50 and
   inter-chunk p50 are logged beside the in-process numbers;
7. observability and chaos on the card (``run_observability``): (a)
   phase 6's serving run again with ``enable_metrics`` on: the counters
   equal what the run counts another way (prefill chunks, decode
   forwards and their batch sizes, admitted sequences, KV blocks
   allocated and freed), the paged launches 12 per decode forward the
   counters record, the launches those of the run with metrics off,
   ``gauges_agree()`` True, every sequence's timeline queued ->
   admitted -> prefill_chunk -> token x 32 -> finished, one step record
   per engine step; tokens/s and decode-step p50 with metrics off and
   on; (b) ``llm_decode:at=OBS_DECODE_AT`` over four requests in
   process (one sequence ends with an error event, its blocks freed, the
   others' tokens those of the fault-free run) and
   ``llm_chunk_write:at=OBS_CHUNK_WRITE_AT`` over the wire through the
   router (one sequence cancelled, its stream resumed on the other
   backend after the router's deadline, every stream's tokens the
   fault-free run's), each fault counted once and flight-recorded; (c)
   BERT at full width and 2 layers, bf16 with the fused flags, captured,
   under ``nonfinite_grad:step=3``: one capture over 5 steps, step 3
   leaving every parameter, master, moment and the step counter as step
   2 left them, ``nonfinite_steps_total`` 1 after a flush, and the run
   equal to its eager twin bit for bit; then ``loss_spike:step=4``,
   which the anomaly sentinel flags at step 4; the captured step's host
   ms with metrics off and on, in turns; (d) under ``torch.profiler``
   the engine's ``LLMEngine.step`` span around each decode step and
   ``TrainStep``'s around each replay;
8. the live observability plane on the card (``run_plane``): (a)
   GPT-2-small served with ``enable_metrics`` on and ``metrics_port`` 0,
   the HTTP exporter brought up by ``inference.Server``'s
   ``maybe_start``, a thread scraping ``/metrics``, ``/healthz`` and
   ``/varz`` every ``PLANE_SCRAPE_S`` (every answer a parseable 200):
   phase 6's in-process run (the same tokens and launches as with the
   plane down), then over the wire behind a ``Router`` the 16 requests
   (a ``/trace?ms=500`` window holding ``LLMEngine.step`` spans), the
   speculative streams and the sampled streams that fail over, each
   launching as its forwards imply; the ``serving_*`` series bridged
   from each transport equal its own STATS, the ``llm_*`` and stream
   counters on ``/metrics`` the run's own counts, ``/llm/seqs`` the 16
   requests' timelines, ``/router`` both backends and the failovers,
   ``/alerts`` the default SLO pack, ``/healthz`` 200 naming the card;
   (c) an ``llm_decode`` step wedged for ``PLANE_WEDGE_MS``: the hang
   monitor's ``hang_diagnosis`` names ``_injected_wedge_sleep`` on the
   engine thread, ``/stacks`` lists it there, ``/healthz`` is 503 during
   the wedge and 200 after; (b) BERT-base bf16 fused over the flat fused
   state, b8 x s512, captured, fed by ``DataLoader(num_workers=2)`` +
   ``DeviceLoader``, an ``AsyncCheckpointer`` save mid-run, the goodput
   ledger driven as ``hapi.fit`` drives it and the scraper polling
   throughout (the capture included): the buckets sum to the loop's
   wall, ``jit_compile_cold`` is the capture tracker's seconds,
   ``checkpoint`` the save's host time, ``/goodput`` the ledger's
   snapshot, the program card's FLOPs the analytic count of the step's
   products (``bert_step_flops``), achieved TFLOP/s printed; the run
   equal bit for bit to its eager twin and to a run with
   ``program_analytics`` off; then ``/healthz`` 503 once the training
   heartbeat is older than ``health_heartbeat_timeout_s`` (and a
   ``train_heartbeat`` diagnosis), 200 after the next step; (d) two
   ``FleetReporter``s push to ``/fleet/push``: counters summed, gauges
   ``{host=}``-labelled; (e) the plane off against on in turns (off, on,
   off, on): the captured step's ms, the decode-step p50 and the stack
   sampler's own overhead ratio at ``PLANE_SAMPLE_HZ``;
9. the inference export and the Predictor on the card
   (``run_predictor``): BERT-base (``BertConfig()``, random weights from
   ``SEED``, fp32) saved with ``jit.save`` at ``[None, 128]``
   (``input_ids``, ``token_type_ids``, ``attention_mask``) and loaded
   with ``create_predictor(Config(dir))``; batches ``PRED_BATCHES`` (1,
   3, 8, 17, 64: buckets 1, 4, 8, 32, 64) each run twice, every replay
   bit for bit the eager model at the padded batch (sliced), within
   ``TOL`` of it at the exact batch, its outputs CUDA tensors until
   ``copy_to_cpu``, exactly 25 LayerNorm launches a call and one capture
   per bucket touched; the same weights exported on the CPU, loaded on
   the card (moved there whole, or refused naming its platform) and on
   the CPU, the card's result within ``GRAD_REL_TOL`` of the CPU's;
   ``clone()`` allocating nothing and equal; ``Server(pred,
   max_batch=16, wait_ms=2)`` answering 8 ``Client`` threads x 8
   requests of 1-4 rows, each reply within ``TOL`` of ``pred.run`` on
   the request alone, batches merged (``serving.batch*`` stats), a
   malformed request answered with its ``decode_error`` and the loop
   serving on; seq 512 at buckets 8 and 32; a bf16 copy at bucket 8 bit
   for bit its own eager run, its outputs bf16 and within
   ``PRED_BF16_NOISE`` (2) times the gap of the bf16 model's plain
   composition (LayerNorm through ``layer_norm_plain``) to the fp32
   model (bf16 rounding noise, measured in the run); ``kernels.maybe_flash_attention`` under
   no_grad at head dim 128 with a key-padding mask, both layouts and
   causal settings, each call one flash forward launch and within
   ``FLASH_TOL`` of ``flash_attention_plain``; a 2-layer head-dim-128
   BERT exported with the flash gate lowered to seq 512, its program
   holding the flash forward operator, served at bucket 4 with the same
   checks as BERT-base (5 LayerNorm and 2 flash forward launches a
   call). Per bucket: capture ms, replay p50, the
   eager forward's ms, ``run()``'s ms and host overhead, sequences/s;
   over the wire requests/s and p50/p99 latency; the phase's peak
   memory, each beside the card's name and power limit;
10. the user entry point ``hapi.Model`` on the card (``run_hapi``): (a)
   BERT-base (``BertForPretraining(BertConfig())``, dropout 0.1, seed
   ``SEED``) in bf16 with the fused flags, ``AdamW(1e-4,
   weight_decay=0.01, fused_state=True)``, b8 x s512 from 32
   ``PretrainSamples`` (4 batches an epoch, 2 workers, the seeded
   shuffle), the MLM and NSP labels packed into one int64 label
   (``PackedSamples``, ``packed_loss``): ``Model.fit`` for 2 epochs
   uninterrupted; ``fit(epochs=1, ckpt_dir=, save_steps=4)`` and then a
   fresh ``Model`` over the same directory for 2 epochs (it restores
   step 4 and re-enters through ``iter_from``); the same 8 batches
   through a bare ``TrainStep``: the losses and every leaf of the
   training state bit for bit alike in all three, each fit launching 8
   times the per-step counts, the captured step's stream ms through
   ``fit`` against the bare step's (median of steps 2-4 of each epoch);
   (b) ``evaluate`` with the loss and an NSP-accuracy ``Metric`` (the
   deferred ``compute`` path) and ``predict`` (lag 1), each bit for bit
   a loop of ``EvalStep`` over the same batches; (c)
   ``Model(BertModel(BertConfig())).save(path, training=False,
   input_spec=[InputSpec([None, 128])])`` served by ``create_predictor``
   at batch 3, bit for bit the eager forward at bucket 4; (d) at 2
   layers, one ``fit`` with ``enable_metrics`` on (the step histogram
   counts its steps, the goodput ledger holds ``step_compute`` and
   ``data_wait``) and a divergence drill (NaN losses from
   ``testing.faults``, ``rollback_budget`` 1, a checkpoint a step): one
   rollback, the steps after the checkpoint run again, every parameter
   finite; (e) ``paddle_tpu_torch.verify.run_verification()`` ok, its
   artifact written, every kernel launched;
11. Transformer-base translation (``run_mt``; the flash training gate at
   ``MT_GATE`` = 128 for (a)-(c) and (e)): (a) ``TransformerSeq2Seq`` at
   ``MT_CFG`` (d 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, 37000
   source and target ids, seed ``SEED``) trained through ``Model.fit``
   for 2 epochs of 4 captured steps, batch 32, src 256 / tgt 224, under
   ``Adam(beta1=0.9, beta2=0.98, epsilon=1e-9)`` over ``NoamDecay(512,
   4000)`` and the ``cross_entropy`` loss, fed by an ``InMemoryDataset``
   (2 loader threads, ``local_shuffle(0)``) over slot files a
   ``MultiSlotDataGenerator`` wrote from numpy seed ``SEED``: finite
   losses, one capture, exactly 8 times the per-step launches
   (``mt_launches``: LayerNorm 30, flash forward, dq and dK/dV 18 each),
   the steady step's stream ms, tokens/s and peak memory, and one forward
   and backward at the default gate (plain attention) beside one at the
   phase's gate; (b) the same model at 2 + 2 layers, dropout 0, on the
   card against the CPU: the loss and every gradient within
   ``GRAD_REL_TOL``, the CPU's ReLUs deciding as the card's
   (``ReluSigns``: a unit within rounding of 0 flips either way, and
   moves a whole token's term; the flips and the raw gap are reported);
   (c) ``decode_beam`` of the trained model (beam 4, 4
   sources, max_len 64) against a CPU copy's whose beams choose as the
   card's did (``BeamChoices``: candidates within rounding of a tie rank
   either way on either device): the same hypotheses, their scores and
   each flipped choice's margin within ``MT_BEAM_SCORE_TOL``, the flips
   reported; (e) ``nn.Transformer(normalize_before=True)``
   at d 512, 8 heads, 6 + 6, FFN 2048, batch 4, card against CPU within
   ``GRAD_REL_TOL``, and one ``need_weights=True`` attention call the
   same; (d) ``transformer_remat`` on BERT-base (phase 5c's bf16 fused
   model over the flat fused state, b8 x s512, dropout 0.1, 3 captured
   steps): remat on equal to remat off bit for bit (losses and every
   leaf of the training state), the recompute's 2 LayerNorms and flash
   forward per layer counted, peak memory and step ms of both;
12. ResNet-50 and the rest of the optimizers (``run_resnet``; no kernel
   of the port runs here: cuDNN's convolutions and BatchNorm as the JAX
   composition in torch ops, so the path ``rn_fit`` must launch none):
   (a) ``resnet50(data_format="NHWC")`` from ``SEED`` cast to bf16 as
   the JAX bench builds it (``bench.py:591-617``), 224 x 224, 1000
   classes, ``Momentum(0.1, 0.9)`` and ``cross_entropy``, batch 128 of
   bf16 images from numpy seed ``SEED + 200`` fed by a ``DataLoader``
   with ``RN_WORKERS`` worker processes, ``Model.fit`` for 2 epochs of
   4 captured steps: finite losses, one capture, every BatchNorm buffer
   moved, finite and fp32; images/s (the median stream ms of steps 2-4
   of each epoch), peak memory, the busy share of two profiled replays,
   the FLOPs (2 x the forward's multiply-adds, 3 x that a step); (b) the
   same model under ``LarsMomentum(0.1, 0.9, lars_coeff=0.001,
   lars_weight_decay=5e-4)``, 4 captured steps, images/s; (c) the
   small ResNet (``ResNet(BottleneckBlock, [1, 1, 1, 1])``, full widths,
   fp32, 64 x 64, batch 8) on the card against the CPU, the CPU's ReLU
   and max-pool decisions the card's (``RnSigns``): two-pass statistics
   the loss, every gradient and every updated buffer within
   ``RN_GRAD_TOL``, the default single pass the loss and buffers (its
   gradients reported: the fp32 ``E[x^2] - E[x]^2`` cancels); (d)
   ``resnet_block_remat`` off against on with ``deterministic`` on,
   ResNet-50 bf16 b128, 3 captured steps: losses, parameters, masters,
   velocities and buffers bit for bit, peak memory and step ms of both,
   and a third run with ``deterministic`` off (its cost); (e) the
   space-to-depth stem against the plain one, fp32, within
   ``RN_S2D_TOL``: ResNet-50's stem conv and the JAX test's small model
   end to end; (f) the small ResNet in fp16 under
   ``TrainStep(amp_dtype="float16", scaler=GradScaler())`` fed an inf
   pixel, eager and as a captured replay: parameters, masters,
   velocities, step counter and BatchNorm buffers unchanged; (g) the
   eleven optimizers and four wrappers, 3 updates of ResNet-50's own
   leaves card against CPU within ``TOL``, then each training the small
   ResNet 3 steps captured against eager, bit for bit; (h) ``Model.fit``
   on ResNet-50 bf16 at batch 32 interrupted at step 4 and resumed by a
   fresh ``Model`` against an uninterrupted fit, bit for bit, every
   leaf and buffer;
13. data, tensor and context parallelism (``run_distributed``): (a)
   ``init_parallel_env()`` (NCCL at world size 1, an in-memory store)
   and phase 10's BERT-base bf16 fused fit (the same batches) through
   ``Model.prepare(mesh=create_mesh({"dp": 1}), zero_stage=...)``, a
   captured ``ShardedTrainStep`` whose gradient all-reduce runs inside
   the CUDA graph: ZeRO 0 on the flat fused state against phase 10's bare
   fit run here (every state leaf and loss bit for bit, and the losses
   against phase 10's own), ZeRO 1 and 3 on per-leaf state (losses and
   every parameter bit for bit); launches the per-step counts times the
   steps, the step stream ms, captures, NCCL calls a step, peak memory;
   (b) ResNet-50 bf16 b128 with ``SyncBatchNorm.convert_sync_batchnorm``
   under the world-1 mesh against the plain BatchNorm net: losses and
   every statistic within ``DIST_RN_TOL``, ms a step of both; (c) four
   ranks sharing the card under Gloo, started by ``launch_procs`` (the
   control plane on the path; ``paddle_tpu_torch.testing.dist_worker``'s
   ``chip`` job): ring attention's flash route (B8 per hop) and Ulysses
   (B1/B2) at BERT-base heads (12 x 64), B 1, T = 4 x 4096, causal and
   not, forward and gradients within ``DIST_ATTN_TOL``/``DIST_GRAD_TOL``
   of plain attention over the whole sequence here, each rank's flash
   launches exact (rank r of the causal ring r + 1 hops); a 2-layer
   full-width BERT at dp 4 (ZeRO 1) and dp 2 x mp 2 (the Megatron rule,
   each rank holding and multiplying its blocks), 3 steps, against one
   process's ``TrainStep`` on the global batch; rank 2 slowed on purpose
   and flagged alone by the straggler detector;
14. pipeline, LocalSGD, DGC, fleet and the parameter server
   (``run_phase14``): (a) four Gloo ranks sharing the card (one
   ``launch_procs`` job, ``dist_worker``'s ``chip14``), under the fused
   flags with the flash route on at seq 128, each case held against the
   same algorithm run here on the global batch (losses within
   ``DIST14_LOSS_TOL``, every parameter within ``DIST14_PARAM_TOL``, and
   each rank launching what ``PATH_KERNELS`` names for its path; the DGC
   reference sends the entries the ranks sent and holds their choice to
   a top-k of its own accumulator):
   ``GPipeTrainStep`` on BERT-base (12 layers in 4 stages of 3, M = 4,
   b 32, seq 128), and on the 2-layer full-width BERT (b 8) tensor
   parallelism dp 2 x mp 2 with ZeRO 3, ``LocalSGDStep`` (dp 4, k 2),
   ``DGCTrainStep`` (dp 4, Momentum, sparsity 0.99, rampup 1),
   ``fleet.distributed_optimizer`` with sharding (stage 3) and with
   gradient merge (k 2), and sync ``PSTrainStep`` (2 pserver shards, 2
   trainers, an untied BERT's word embedding a ``SparseEmbeddingPS``
   looked up by the batch's ids); (b) only with four cards: the same job
   under NCCL, one rank a card, with phase 13 (c)'s job and 13 (a)'s fits
   at world 4, and BERT-base bf16 fused at seq 512 (``NCCL14``, one
   global batch), captured, at ZeRO 0 and ZeRO 3 (dp 4) and TP dp 2 x
   mp 2: losses, step ms, peak memory and the bytes a rank holds; the
   fits and the runs are held against one card's run of the same steps
   (losses within ``DIST14_BF16_TOL``, parameters within
   ``DIST14_MOVE_TOL``, both below what an unchanged model reads); on one card
   (b) logs why it did not run. ``python3 chip_smoke.py --distributed``
   runs phases 13 and 14 alone (after the build) and writes
   ``chiprun_out/chip_smoke_distributed.json``;
15. the static programming model and the core op library, on ERNIE 1.0
   base (``ERNIE_CFG``: PaddlePaddle/ERNIE's ``ernie_config.json``, L 12,
   H 768, A 12, vocab 18,000, 513 positions, relu; seeded, b8 x s512):
   (a) slot files of knowledge-masked token ids loaded by an
   ``InMemoryDataset`` and trained in bf16 with the fused loss and Adam
   kernel through ``static.Executor().train_from_dataset`` (2 epochs x 4
   captured steps), the same losses bit for bit as a bare ``TrainStep``
   loop over the same batches, the launches ``expected_launches`` gives
   at vocab 18,000 (9 xent chunks a step), the fused loss against the
   unfused one, step stream ms, tokens/s and peak memory; (b)
   ``jit.to_static(ErnieModel)`` in eval (fp32): one capture, replays
   bit for bit the eager forward, captured against eager ms, LayerNorm
   launches a forward (attention at s 512 and d 64 takes the plain eval
   route), ``jit.save``/``load`` of it within ``TOL``; (c)
   ``Executor.run`` of a ``Program`` whose ``to_static`` body computes
   ERNIE's pretraining loss from a ``Scope``'s parameters with a tensor
   ``if``, its ``clone(for_test=True)``, and ``check_nan_inf`` (a feed
   poisoned with inf raises, a clean one does not; the check's ms a
   run); (d) the converted functions of ``tests/test_dy2static.py`` on
   the card against the CPU, each captured or (a tensor loop) run
   eagerly with its reason; (e) every public function of the eight op
   modules on the card against the CPU within ``OPS_RTOL``/``OPS_ATOL``,
   the random ones by shape, dtype, device, moments and the same draw
   from the same key, and ``matmul`` at [4096, 768] x [768, 3072] under
   ``matmul_precision`` float32 and tensorfloat32 against float64 (TF32
   must show its error). ``python3 chip_smoke.py --static`` runs this
   phase alone and writes ``chiprun_out/chip_smoke_static.json``;
16. the recurrent and sequence stack (A17 part 2): (a) the PTB LSTM
   language model "large" (``PTB_CFG``: Zaremba et al. 2014, 2 layers,
   hidden 1,500, vocabulary 10,000, dropout 0.65, untied; ~66 M
   parameters) on seeded Zipf ids, b20 x 35 unrolled steps, through
   ``hapi.Model.fit`` with ``SGD(1.0)`` and ``ClipGradByGlobalNorm(10)``
   for ``PTB_STEPS`` captured steps: finite losses, one capture, no kernel
   of the port launched, the same losses bit for bit as the same steps
   eager, step ms (median of steps 3-8), tokens/s and peak memory; one
   forward and backward at dropout 0 on the card against the CPU
   (``PTB_LOSS_TOL``, ``PTB_GRAD_TOL``), and ``torch.nn.LSTM`` (cuDNN,
   a yardstick never on the path) on the port's weights transposed, its
   output gap (``PTB_CUDNN_TOL``) and its forward and backward ms beside
   the port's; (b) ``CRNNCTC`` (95 classes, height 32, base 64, GRU 256)
   on seeded [64, 1, 32, 256] images (64 frames) and labels of 8-24
   characters, ``CRNN_STEPS`` captured steps of ``Adam`` under
   ``fused_adam`` (the leaf kernel once a step), its CTC loss against
   ``torch.nn.functional.ctc_loss`` reduced the same way (``CTC_TOL``,
   both ms), the greedy decode and the edit distance of the same logits
   on the card and on the CPU equal; (c) ``SRLBiLSTMCRF`` (vocabulary
   20,000, 59 tags, embed 32, hidden 512, 2 layers) on b32 with ragged
   lengths 8-64: loss and gradients on the card against the CPU
   (``SRL_*``), the Viterbi paths equal but for ties (counted),
   ``chunk_eval``'s counts equal, and ``SentimentBiLSTM``'s logits on the
   same batch; (d) ``SkipGramNCE`` (vocabulary 100,000, 300 dims, 5
   negatives, b1024): NCE loss and gradients on given negatives against
   the CPU (``W2V_TOL``), the sampled path by shape, device and the same
   draw from the same seed, then the embedding's ``embedding_grad``
   (merged) through ``SGD`` and lazy ``Adam``: each equal to the dense
   update on the touched rows bit for bit, every other row (and moment)
   unchanged, and the ms of both; (e) every public function of
   ``ops.sequence``, ``crf``, ``rnn_functional``, ``sampling`` and
   ``sparse`` and the CTC losses on the card against the CPU within
   ``OPS_RTOL``/``OPS_ATOL`` (``testing/op_cases.py``'s
   ``SEQ_CASES``). ``python3 chip_smoke.py --recurrent`` runs this phase
   alone and writes ``chiprun_out/chip_smoke_recurrent.json``;
17. runs the vision slice (fp32 checks with TF32 off): (a) MobileNetV2
   1.0 at 224 (ImageNet's 1000 classes), NHWC, bf16 with fp32 masters,
   b128 through ``Model.fit`` with ``Adam`` under ``fused_adam`` for 8
   captured steps with deterministic convolutions: one capture, the Adam
   leaf kernel exactly once a step, the 8 losses bit for bit with the
   same steps run eagerly, step ms, images/s, peak memory, a profiled
   replay split into convolutions, matmuls and PyTorch's own kernels
   (BatchNorm's composition among them), the default convolutions'
   replay ms; then one fp32 forward and backward at batch 4, card against
   CPU, with two-pass statistics and the ReLU6 decisions shared
   (``ReluSigns``): the loss within ``P17_LOSS_TOL`` relative, each
   leaf's fp32 gradient within ``P17_GRAD_TOL`` of its largest entry or
   ``P17_NOISE_K`` times the CPU's own fp32 gap from a float64 run
   (cuDNN's Winograd weight gradient, where it explains a leaf, within
   ``P17_WINOGRAD_TOL``), and in float64 each leaf within
   ``P17_GRAD_TOL``; (b)
   SSDLite at its defaults (20 classes, 128 px, base 32), b32: the loss
   card against CPU as (a)'s check, its priors equal to the CPU's, 4
   captured Momentum steps, ``predict`` on the card against the CPU (the
   port's NMS on both), the CPU taking the card's choices where scores
   tie within ``SSD_TIE`` (``NmsChoices``; ties counted): the same valid
   rows and labels, scores and boxes within 1e-5; (c) the DCGAN's
   ``GANTrainStep`` 8 times on the card, its first step against the CPU
   fed the card's z; (d) VGG-16-BN (dropout 0), MobileNetV1 and LeNet,
   one forward and backward each, card against CPU as (a)'s; (e) every
   call of ``VISION_CASES``, ``DET_CASES`` and ``DET_CREATION`` on the
   card against the CPU within ``OPS_RTOL``/``OPS_ATOL``, the sampled
   ops by shape and seed. ``python3 chip_smoke.py --vision`` runs this
   phase alone and writes ``chiprun_out/chip_smoke_vision.json``;
18. runs the slice of MoE, Transformer-XL, the recommenders and the data
   modules (fp32, TF32 off): (a) Transformer-XL at enwik8 "base" width
   (``TXL_CFG``: 12 layers, d 512, 8 heads, d_ff 2048, tgt_len and
   mem_len 512, batch 22, dropout 0.1) through its captured
   ``TransformerXLTrainStep`` with ``Adam`` under ``fused_adam`` over 6
   consecutive segments of one seeded byte stream: one capture, LayerNorm
   24 launches a step and the Adam leaf kernel one, the losses, memories
   and parameters bit for bit with the same steps eager, ``valid`` at
   min(512, 512 s), step ms, tokens/s, peak memory, ``reset_mems`` in
   place followed by a step equal to the eager twin's and a fresh step's;
   then 2 layers at the full widths, batch 2, dropout 0, two segments,
   card against CPU (``P18_LOSS_TOL``, ``P18_GRAD_TOL``); (b) the MoE net
   of ``tests/test_moe.py`` at Switch-Base's expert width with four
   residual MoE blocks (``MOE_SWITCH``) on a [32, 128, 768]
   batch: one card's captured ``TrainStep``, then ``ShardedTrainStep``
   with ``moe_param_rule("ep")`` at dp 1 x ep 4 and dp 2 x ep 2 on four
   Gloo ranks sharing the card (and, on four cards, under NCCL, one rank
   a card), 3 Adam steps each: losses, ``aux_loss`` and every whole
   parameter within ``P18_MOE_*`` of the reference, the dropped choices
   equal, each rank holding E / ep experts, its bytes, collectives and
   (NCCL) step ms and peak; (c) ``RecommenderSystem`` at MovieLens-1M's
   widths through ``Model.fit`` on the synthetic ``Movielens`` (4
   captured steps), then it and ``DeepFM`` (26 fields of 100,000 ids,
   embed 16, hidden 400 x 3, ReLU decisions shared) card against CPU;
   (d) ``Tokenizer`` build/encode/save/load, ``Imikolov`` on a PTB tar
   the script writes (native ids equal to the Python path's), a
   ``reader`` chain feeding an N-gram LM's steps, every distribution's
   ``log_prob``/``entropy`` card against CPU. ``python3 chip_smoke.py
   --zoo`` runs this phase alone and writes
   ``chiprun_out/chip_smoke_zoo.json``;
19. runs the compat slice (the last modules of the JAX package; fp32,
   TF32 off) over BERT-base (``bert_base_config``, dropout 0, b8 x s512,
   every Linear wrapped by ``slim.quantize_model``: 75
   ``QuantizedLinear``s): (a) QAT under ``fused_softmax_xent`` and
   ``fused_adam`` through the fluid spellings,
   ``fluid.Executor(fluid.CUDAPlace(0)).train_from_dataset`` of an
   ``InMemoryDataset`` inside ``fluid.scope_guard`` and
   ``incubate.train_epoch_range`` (2 epochs x 4 captured steps, Adam at a
   ``fluid.layers.exponential_decay``): one capture, the launches
   ``expected_launches`` gives, the 8 losses and every ``act_scale`` bit
   for bit with the same steps eager, a fresh range on an interrupted
   run's directory resuming at epoch 2 and ending bit for bit with the
   uninterrupted run, the trained parameters and ``act_scale``s through a
   ``fluid.Scope``, ``fluid.io.save_persistables`` and a fresh scope bit
   for bit, step ms, tokens/s and peak memory; (b) 2 layers at the full
   widths, batch 2, one QAT forward and backward card against CPU with
   the card's round decisions shared (``RoundShare``; each flip within
   ``QAT_TIE`` of a half step): loss, gradients and ``act_scale``s within
   ``QAT_LOSS_TOL``/``QAT_GRAD_TOL``; (c) ``PostTrainingQuantization`` on
   2 eval batches, ``convert_to_int8`` and the int8 forward: the int32
   accumulators of ``INT8_LAYERS`` (``torch._int_mm`` over zero-padded
   operands) equal to the CPU's bit for bit, the MLM logits within
   ``INT8_LOGIT_BOUND`` of the fake-quant model's (mean |gap| over mean
   |logit|), the fp32, fake-quant and int8 forward ms; (d)
   ``nn.functional.multihead_matmul`` against its plain version at
   ``MHM_SHAPES`` (the flash forward launched once where the eval gate
   admits the call, at 8192 keys, and not at 512); (e) a fresh
   ``FLAGS_compile_cache_dir``: a first process compiles the LayerNorm
   library there (misses), a second loads it (hits, no miss), and
   ``sysconfig.get_include``/``get_lib`` name directories holding the
   header and the library. ``python3 chip_smoke.py --compat`` runs this
   phase alone and writes ``chiprun_out/chip_smoke_compat.json``;
20. prints one ``{"kernels": [...]}`` line with each kernel's launches,
   error and times, and last one ``{"ok": true, "device": {...}}`` line.
   Launch counts are set to 0 just before each run of a path (each
   training run, each engine run) and read just after it; each path
   must launch the kernels it needs (``PATH_KERNELS``).

Any failure raises, so the exit code is non-zero and no result line is
printed. Every number and message also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

# fp32 kernel vs plain PyTorch: the same arithmetic summed in another
# order; observed differences are ~1e-6 on unit-scale inputs
TOL = 1e-5
# a token that differs from dense generate() is accepted only where the
# dense top-two logits are closer than this (fp32 summation-order noise
# can flip such a near-tie)
NEAR_TIE = 1e-4
SEED = 0
# the sampled runs' temperature
TEMPERATURE = 0.8
# flash attention kernel vs plain PyTorch: fp32 sums over up to 512 keys
# (forward) or queries (dk, dv) in another order; the dropout masks are
# the same hash bit for bit, so they add no slack
FLASH_TOL = 2e-5
FLASH_GRAD_TOL = 5e-5
# card against CPU, a 2-layer BERT: the loss within 1e-5 relative (fp32
# sums in another order). Every parameter's gradient within
# GRAD_REL_TOL of its largest entry: the check of the gradients' size,
# which a kernel that scaled dq/dk/dv wrongly would fail by ~1e-1 or
# more (2.6e-6 measured at worst on an H100, so the limit leaves 7x for
# summation-order noise). Then, after one
# TrainStep, every parameter within a fifth of the step size lr = 1e-4.
# An Adam step moves a weight by up to ~lr whatever its gradient's size
# (it sees little more than the gradient's sign), dividing by sqrt(v) +
# eps, so where |g| is near eps * sqrt(1 - b2) / (1 - b1) ~ 3e-7 fp32
# gradient noise of ~1e-8 moves the update by a few percent of lr
# (6.5e-6 measured on an H100); a gradient of the wrong sign moves it by
# ~lr
STEP_LOSS_RTOL = 1e-5
GRAD_REL_TOL = 2e-5
STEP_PARAM_TOL = 2e-5
# fused xent kernels vs plain: fp32 logits summed over H in another order
# (stages of 32 or 64 against cuBLAS's, in 3xTF32, whose dropped lo.lo
# term is ~2^-22 of a product), the online logsumexp against torch's
# two-pass one. Loss and lse absolute (a loss of ~10); gradients relative
# to each gradient's largest entry (dW and db sum over 4096 rows). An H100
# measured 7.2e-6 (loss) and 3.6e-6 (gradients); a wrong tile or mask
# gives 1e-1
XENT_TOL = 1e-4
XENT_GRAD_TOL = 1e-4
# bf16 operands through the wrappers' cast path (the kernels read fp32
# copies) against the plain versions on the same bf16 inputs, both on the
# card: both compute in fp32 and round once to bf16, so a bf16 output or
# gradient agrees to one bf16 step of its largest entry (a value in
# [2^e, 2^(e+1)) rounds in steps of 2^(e-7)); fp32 outputs (the xent loss,
# db of an fp32 bias) keep their fp32 tolerances
BF16_TOL = 2.0 ** -7
# the fused training run's peak device memory at b8 x s512, in GiB (4.00
# before the chunked backward; its scratch adds 32 MB)
FUSED_PEAK_GB = 4.25
# bf16 card against CPU (2-layer BERT, one step, both in bf16): the card's
# kernels read fp32 copies and round once, the CPU's LayerNorm, matmuls and
# GELU round bf16 in other places, so the two differ at bf16's precision.
# A CPU emulation of the card's LayerNorm cast path gave a loss 4.9e-4
# apart, gradients up to 3.0% of their leaf's largest entry and 0.25% of
# master entries more than lr/2 apart; cuBLAS's and the GELU's own
# rounding add to that on the card. A lost cast (a gradient left unscaled
# or in the wrong dtype, a master not written) is off by ~100%. After one
# step a master entry moves by ~lr whatever its gradient's size, so a
# near-zero gradient whose sign bf16 rounding flips sends it ~2 lr the
# other way: the masters are checked by the share of entries more than
# lr/2 apart, and none may be more than Adam's two steps apart
BF16_STEP_LOSS_RTOL = 1e-2
BF16_GRAD_TOL = 0.1
BF16_MASTER_SHARE = 0.01
BF16_MASTER_MAX_LR = 2.05
# the kernels each path of the main path must launch: plain decode,
# speculative decode (a self-draft's dense forwards plus the verify),
# and BERT training at seq 512 (split backward) and seq 128 (fused)
PATH_KERNELS = {"serving": ("layer_norm", "paged_attention"),
                "speculative": ("layer_norm", "paged_attention_multiquery"),
                # the same engine paths served over the wire (phase 6b)
                "wire": ("layer_norm", "paged_attention"),
                "wire_speculative": ("layer_norm",
                                     "paged_attention_multiquery"),
                "wire_failover": ("layer_norm", "paged_attention"),
                "train_seq512": ("layer_norm", "flash_attention_fwd",
                                 "flash_attention_bwd_dq",
                                 "flash_attention_bwd_dkv"),
                "train_seq128": ("layer_norm", "flash_attention_fwd",
                                 "flash_attention_bwd_fused"),
                "train_seq512_fused": ("layer_norm", "flash_attention_fwd",
                                       "flash_attention_bwd_dq",
                                       "flash_attention_bwd_dkv",
                                       "fused_xent_fwd", "fused_xent_bwd_dlog",
                                       "fused_xent_bwd_dh",
                                       "fused_xent_bwd_dw", "adam_leaf"),
                "train_seq128_pallas_adam": ("layer_norm",
                                             "flash_attention_fwd",
                                             "flash_attention_bwd_fused",
                                             "adam_flat"),
                # BERT-base in bf16 as the JAX bench builds it: the same
                # kernels through the wrappers' fp32 cast path, the Adam
                # kernel on the fp32 masters (one flat master under
                # fused_state)
                "train_seq512_bf16": ("layer_norm", "flash_attention_fwd",
                                      "flash_attention_bwd_dq",
                                      "flash_attention_bwd_dkv"),
                "train_seq512_bf16_fused": (
                    "layer_norm", "flash_attention_fwd",
                    "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                    "fused_xent_fwd", "fused_xent_bwd_dlog",
                    "fused_xent_bwd_dh", "fused_xent_bwd_dw", "adam_leaf"),
                # flash_attention_with_lse (no caller on the main path:
                # ring attention is not ported yet), forward and backward
                # through its router on both backward routes
                "flash_with_lse": ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv",
                                   "flash_attention_bwd_fused")}
# phase 7 (observability and chaos): serving with metrics on, the fault
# drills in process and over the wire, the captured bf16 fused step under
# value faults (and its eager twin)
PATH_KERNELS.update({
    "obs_serving": PATH_KERNELS["serving"],
    "obs_serving_chaos": PATH_KERNELS["serving"],
    "obs_wire_chaos": PATH_KERNELS["wire"],
    "obs_train_chaos": PATH_KERNELS["train_seq512_bf16_fused"],
    "obs_train_chaos_eager": PATH_KERNELS["train_seq512_bf16_fused"],
    "obs_train_spike": PATH_KERNELS["train_seq512_bf16_fused"]})
# every training run has a captured twin (TrainStep's CUDA graph): the
# same kernels, launched by the graph's replays
CAPTURED = "_captured"
PATH_KERNELS.update({name + CAPTURED: PATH_KERNELS[name] for name in (
    "train_seq512", "train_seq128", "train_seq512_fused",
    "train_seq128_pallas_adam", "train_seq512_bf16",
    "train_seq512_bf16_fused")})
# the fused flags of slice 3 (all off by default, as in the JAX package)
FUSED_FLAGS = {"fused_softmax_xent": True, "fused_adam": True}
# BERT-base pretraining as the JAX package's bench runs it
# (bench.py bench_bert: BertConfig(), AdamW(1e-4, weight_decay=0.01)):
# under the default flags, then with the fused loss and the leaf Adam
# kernel, then with the flat Adam kernel (use_pallas_adam)
TRAIN_RUNS = {"train_seq512": dict(batch=8, seq=512, gate=512),
              "train_seq128": dict(batch=32, seq=128, gate=128),
              "train_seq512_fused": dict(batch=8, seq=512, gate=512,
                                         flags=FUSED_FLAGS,
                                         max_peak_gb=FUSED_PEAK_GB),
              "train_seq128_pallas_adam": dict(
                  batch=32, seq=128, gate=128,
                  flags={"use_pallas_adam": True})}
# the JAX bench's own build (bench.py:372-383): the model cast with
# cast_model_to_low_precision(..., "bfloat16"), then AdamW(1e-4,
# weight_decay=0.01, fused_state=...); default flags per leaf, and the fused
# loss and Adam kernel over the flat fused state
BF16_RUNS = {"train_seq512_bf16": dict(batch=8, seq=512, gate=512,
                                       fused_state=False),
             "train_seq512_bf16_fused": dict(batch=8, seq=512, gate=512,
                                             flags=FUSED_FLAGS,
                                             fused_state=True)}
# the runs profiled with torch.profiler (one step each)
# phase 5c: the fed, resumed and evaluated runs. BERT at full width, b8 x
# s512 as the JAX bench feeds it (72 masked positions a row, bench.py's
# 15% rounded to 8), RESUME_STEPS captured steps saved at RESUME_AT; the
# bf16 fused run at full depth, the fp32 default run at 2 layers (its
# checkpoint format and resume are the same; the depth keeps the script in
# time)
RESUME_BATCH, RESUME_SEQ, RESUME_MASKED = 8, 512, 72
RESUME_STEPS, RESUME_AT, RESUME_WORKERS = 8, 4, 2
RESUME_RUNS = {"resume_bf16_fused": dict(layers=12, dtype="bfloat16",
                                         flags=FUSED_FLAGS,
                                         fused_state=True),
               "resume_fp32": dict(layers=2, dtype="float32", flags={},
                                   fused_state=False)}
EVAL_CALLS = 6
# the checkpoints of the resume runs (removed after each run)
CKPT_DIR = "chip_smoke_ckpt"
PATH_KERNELS.update({
    "data_feed": PATH_KERNELS["train_seq512_bf16_fused"],
    "resume_bf16_fused": PATH_KERNELS["train_seq512_bf16_fused"],
    "resume_fp32": PATH_KERNELS["train_seq512"],
    # eval attention below flash_attention_min_seq is the plain path
    "eval_captured": ("layer_norm",)})
PROFILED_RUNS = ("train_seq512", "train_seq512_fused", "train_seq512_bf16",
                 "train_seq512_bf16_fused")
TRAIN_STEPS = 5
# (rows, eps) of the LayerNorm kernel's calls: serving decode and prefill,
# and BERT training's [B*T, 768] (encoder eps 1e-5; embeddings and MLM
# transform 1e-12)
LN_SHAPES = ((8, 1e-5), (16, 1e-5), (512, 1e-5), (4096, 1e-5),
             (4096, 1e-12))
# (rows, cols) beyond the paths' own: the warp-per-row kernel's scalar
# loads (cols % 4 != 0) and a row above its register cap (block per row)
LN_EXTRA_SHAPES = ((64, 45), (64, 770), (64, 4096),
                   # phase 11's: Transformer-base's encoder and decoder
                   # rows (b32 x 256 and x 224) at d 512
                   (8192, 512), (7168, 512))
# the paged kernels' main shape: 16 sequences of 12 heads of 64, block
# size 16, ragged lens from 1 to 1024 with block remainders; the verify
# window VERIFY_QMAX rows with ragged q_lens (never above the context)
PAGED_LENS = [1, 17, 64, 100, 128, 255, 256, 333, 400, 511, 512, 640, 777,
              900, 1000, 1024]
PAGED_HEADS, PAGED_DIM, PAGED_BS = 12, 64, 16
VERIFY_QMAX = 4
VERIFY_QLENS = [min(q, n) for q, n in zip([4, 1, 3, 2] * 4, PAGED_LENS)]
# the verify kernel against its plain versions: fp32 sums in another
# order (~5e-7 observed on the single-query kernel); a wrong mask or merge
# gives 1e-1
VERIFY_TOL = 5e-6
# the engine runs: 16 requests of 16..512 prompt tokens and 32 new ones,
# the first 4 of them again speculative (k = 3, windows of 4)
SERVING = dict(n_req=16, lo=16, hi=512, max_new=32, pool_blocks=1024,
               n_spec=4)
SPEC_K = 3

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores (the unit the SIMT kernels run on) and dense TF32 on the
# tensor cores, of which 3xTF32 (three products per fp32 product: the xent
# kernels and the flash kernels up to D = 128) gets a third
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3

# the kernels redesigned since their port and their design, for the
# kernels line (the designs they replaced are timed in PERF.md)
DESIGNS = {
    "flash_attention_fwd": (
        "3xTF32 mma.sync, 128 query rows a block (16 a warp, the online "
        "softmax in registers in the fragment layout), cp.async ring of "
        "32-key K/V tiles, P fed from registers to O += P V (V read in "
        "key pairs), two blocks per SM at D <= 64; replaced fp32 SIMT FMA "
        "tiles"),
    "flash_attention_bwd_dq": (
        "3xTF32 mma.sync, Q and dO resident (128 rows a block, 16 a "
        "warp), cp.async ring of 32-key K/V tiles, dS formed in registers "
        "and fed to dQ += dS K (K read in key pairs), no atomics, two "
        "blocks per SM at D <= 64; replaced fp32 SIMT FMA tiles"),
    "flash_attention_bwd_dkv": (
        "3xTF32 mma.sync tiles, K/V resident, cp.async ring over query "
        "tiles, two blocks per SM; replaced fp32 SIMT FMA tiles"),
    "fused_xent_fwd": (
        "3xTF32 wgmma m64n128k8, W split once per stage in shared memory, "
        "128x128 logits tiles folded in registers; replaced fp32 SIMT FMA "
        "tiles"),
    "flash_attention_bwd_fused": (
        "3xTF32 mma.sync, one block per (batch, head): Q and dO resident, "
        "cp.async ring of 16-key K/V sub-tiles; per sub-tile the dq "
        "kernel's step (dS in registers, dQ += dS K accumulated in "
        "registers over the scan), then Pv^T and dS^T through shared "
        "memory for dV and dK written straight out; lo of each split "
        "passed unrounded; no atomics, two blocks per SM at D <= 64; "
        "replaced fp32 SIMT FMA tiles"),
    "paged_attention": (
        "split-KV: one block per (head, sequence, 128-token chunk) over a "
        "work list of the real chunks; a 32-token K/V tile a warp by "
        "cp.async, lane-per-token q.k, one max and one sum per tile, lanes "
        "over D for P V; the chunks merged in chunk order by the block "
        "that draws the last ticket, in one launch; replaced one block per "
        "(head, sequence) with a per-token online softmax"),
    "paged_attention_multiquery": (
        "the single-query kernel's split-KV design with the whole window "
        "in the block: each 32-token K/V tile copied once and used by "
        "every window row (groups of 4 rows a pass), per-row causal "
        "limits with p = 0 past them, one max and one sum per row and "
        "tile, every row's chunks merged in chunk order by the last "
        "ticket; replaced one block per (head, sequence, window row) with "
        "a per-token online softmax"),
    "layer_norm": (
        "one warp per row, 4 rows a block, the row in registers (float4 "
        "where aligned); x, w and b loaded in one round before the shuffle "
        "reductions (mean, then the centred sum of squares), no block "
        "barrier; a block per row above 1024 columns; replaced a 256-thread "
        "block per row with three passes and block reductions"),
}

GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, num_layers=12,
                  num_heads=12, intermediate_size=3072,
                  max_position_embeddings=1024, layer_norm_epsilon=1e-5)

REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)
    REPORT.setdefault("log", []).append(msg)


def timed(fn) -> float:
    """Seconds ``fn()`` takes."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of one call, averaged over ``iters`` calls, with the
    50 MB L2 flushed before each (the serving path meets every pool and
    activation cold: twelve layers' pools pass between two calls). After
    the 1 GiB flush the card spins for ~2.5 ms (``torch.cuda._sleep``)
    while the host enqueues the call, so the time is the device's, not
    the host's launch latency (an autograd backward enqueues dozens of
    kernels)."""

    SPIN_CYCLES = 5_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 ** 28, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_inputs(torch, rng, b, qmax, h, d, bs, lens, qlens=None):
    """Ragged block tables over a shuffled pool, garbage past each
    sequence's blocks (negative and out-of-pool entries included)."""
    nb = [-(-n // bs) for n in lens]
    n_blocks = sum(nb) + 8
    maxb = max(nb)
    perm = rng.permutation(n_blocks)
    tbl = rng.integers(-5, n_blocks + 5, size=(b, maxb)).astype(np.int32)
    off = 0
    for i, k in enumerate(nb):
        tbl[i, :k] = perm[off:off + k]
        off += k
    shape_q = (b, h, d) if qmax is None else (b, qmax, h, d)
    dev = dict(device="cuda")
    t = {
        "q": torch.from_numpy(rng.standard_normal(shape_q,
                                                  np.float32)).cuda(),
        "k": torch.from_numpy(rng.standard_normal(
            (n_blocks, bs, h, d), np.float32)).cuda(),
        "v": torch.from_numpy(rng.standard_normal(
            (n_blocks, bs, h, d), np.float32)).cuda(),
        "tbl": torch.tensor(tbl, dtype=torch.int32, **dev),
        "lens": torch.tensor(lens, dtype=torch.int32, **dev),
    }
    if qlens is not None:
        t["qlens"] = torch.tensor(qlens, dtype=torch.int32, **dev)
    return t, sum(nb)


def sdpa_inputs(torch, t, bs, qmax):
    """Dense gathered K/V [B, H, T, D] and the boolean mask that give the
    same function through scaled_dot_product_attention."""
    b, maxb = t["tbl"].shape
    idx = t["tbl"].long().clamp(0, t["k"].shape[0] - 1)
    h, d = t["k"].shape[2:]
    kd = t["k"][idx].reshape(b, maxb * bs, h, d).transpose(1, 2).contiguous()
    vd = t["v"][idx].reshape(b, maxb * bs, h, d).transpose(1, 2).contiguous()
    lens = t["lens"].long()
    kpos = torch.arange(maxb * bs, device="cuda")
    if qmax is None:
        q = t["q"][:, :, None]
        mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
    else:
        q = t["q"].transpose(1, 2).contiguous()
        qlens = t["qlens"].long()
        qpos = (lens - qlens)[:, None] + torch.arange(qmax, device="cuda")
        mask = ((kpos[None, None, :] <= qpos[:, :, None])
                & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    return q, kd, vd, mask


def check_paged(torch, pa, args, what: str):
    """The single-query kernel against paged_attention_plain (rows with a
    context: the plain version's empty row is a uniform average, the
    kernel's and the JAX kernel's 0) and against its split decomposition
    paged_attention_split_plain (every row), bitwise equal on a second
    run. Returns both errors."""
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    split = pa.paged_attention_split_plain(*args)
    torch.cuda.synchronize()
    rows = args[4] > 0
    err = float((got[rows] - want[rows]).abs().max())
    split_err = float((got - split).abs().max())
    if not (torch.isfinite(got).all() and err <= TOL and split_err <= TOL
            and torch.equal(got, again)):
        raise AssertionError(
            f"paged_attention kernel ({what}) differs from plain by {err} "
            f"and from the split plain version by {split_err} (tolerance "
            f"{TOL}), or from itself run to run: "
            f"{not torch.equal(got, again)}")
    return err, split_err


def time_paged(torch, timer, pa, t, args, bs, used_blocks) -> dict:
    """Times of the single-query kernel, its plain version and SDPA over
    the gathered K/V (the yardstick the port never calls), and the bound:
    q, K and V of every context token and the table entries read once,
    the output written once."""
    F = torch.nn.functional
    b, h, d = t["q"].shape
    ntok = int(t["lens"].clamp_min(0).sum())
    bms, by = bound(4 * (2 * b * h * d + 2 * ntok * h * d + used_blocks + b),
                    4 * ntok * h * d)
    q, kd, vd, mask = sdpa_inputs(torch, t, bs, None)
    want = pa.paged_attention_plain(*args)
    rows = t["lens"] > 0
    lib_err = float((F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=mask)[:, :, 0][rows] - want[rows]).abs().max())
    return {"ms": timer(lambda: pa.paged_attention(*args)),
            "plain_ms": timer(lambda: pa.paged_attention_plain(*args)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask)),
            "library_max_abs_err": lib_err, "bound_ms": bms,
            "bound_by": by}


def check_verify(torch, pa, args, what: str):
    """The verify kernel against paged_attention_multiquery_plain and its
    split decomposition paged_attention_multiquery_split_plain (every row,
    padded ones included), bitwise equal on a second run, within
    VERIFY_TOL. Returns both errors."""
    got = pa.paged_attention_multiquery(*args)
    again = pa.paged_attention_multiquery(*args)
    want = pa.paged_attention_multiquery_plain(*args)
    split = pa.paged_attention_multiquery_split_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    split_err = float((got - split).abs().max())
    if not (torch.isfinite(got).all() and err <= VERIFY_TOL
            and split_err <= VERIFY_TOL and torch.equal(got, again)):
        raise AssertionError(
            f"paged_attention_multiquery kernel ({what}) differs from plain "
            f"by {err} and from the split plain version by {split_err} "
            f"(tolerance {VERIFY_TOL}), or from itself run to run: "
            f"{not torch.equal(got, again)}")
    return err, split_err


def time_verify(torch, timer, pa, t, args, bs, used_blocks) -> dict:
    """Times of the verify kernel, its plain version and SDPA over the
    gathered K/V with the window mask, and the bound: q, K and V of every
    context token and the table entries and lengths read once, the
    output written once; 4 flops per (row, visible key, dim)."""
    F = torch.nn.functional
    b, qmax, h, d = t["q"].shape
    lens, qlens = t["lens"].tolist(), t["qlens"].tolist()
    rows_keys = sum(min(n - ql + qi + 1, n) if qi < ql else n
                    for n, ql in zip(lens, qlens) for qi in range(qmax))
    bms, by = bound(4 * (2 * b * qmax * h * d + 2 * sum(lens) * h * d
                         + used_blocks + 2 * b), 4 * rows_keys * h * d)
    q, kd, vd, mask = sdpa_inputs(torch, t, bs, qmax)
    return {"ms": timer(lambda: pa.paged_attention_multiquery(*args)),
            "plain_ms": timer(lambda: pa.paged_attention_multiquery_plain(
                *args)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask)),
            "bound_ms": bms, "bound_by": by}


def engine_prompt_lens() -> list:
    """Prompt lengths of run_serving's requests (make_prompts' lengths do
    not depend on the vocabulary)."""
    return [len(p) for p in make_prompts(SERVING["n_req"], SERVING["lo"],
                                         SERVING["hi"], 2)]


def check_layer_norm(torch, timer, ln, rng) -> dict:
    """The LayerNorm kernel against layer_norm_plain at the paths' shapes
    (timed, with the launch floor: an empty kernel under the same timer)
    and at LN_EXTRA_SHAPES, bitwise equal on a second run everywhere."""
    F = torch.nn.functional
    err = 0.0
    per_shape = {}
    shapes = [(rows, 768, eps) for rows, eps in LN_SHAPES] + [
        (rows, cols, 1e-5) for rows, cols in LN_EXTRA_SHAPES]
    for rows, cols, eps in shapes:
        x = torch.from_numpy(rng.standard_normal((rows, cols),
                                                 np.float32)).cuda()
        w = torch.from_numpy(1 + 0.1 * rng.standard_normal(
            cols, np.float32)).cuda()
        b = torch.from_numpy(0.1 * rng.standard_normal(
            cols, np.float32)).cuda()
        got = ln.layer_norm(x, w, b, eps)
        again = ln.layer_norm(x, w, b, eps)
        want = ln.layer_norm_plain(x, w, b, eps)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not (e <= TOL and torch.equal(got, again)):
            raise AssertionError(
                f"layer_norm kernel at [{rows},{cols}] differs from plain "
                f"by {e} > {TOL}, or from itself run to run: "
                f"{not torch.equal(got, again)}")
        err = max(err, e)
        key = f"[{rows},{cols}] eps {eps:g}"
        per_shape[key] = {"max_abs_err": e}
        if cols == 768:
            bms, by = bound((2 * rows * cols + 2 * cols) * 4,
                            8 * rows * cols)
            per_shape[key].update(
                ms=timer(lambda: ln.layer_norm(x, w, b, eps)),
                plain_ms=timer(lambda: ln.layer_norm_plain(x, w, b, eps)),
                library_ms=timer(lambda: F.layer_norm(x, (cols,), w, b,
                                                      eps)),
                bound_ms=bms, bound_by=by)
        log(f"layer_norm {key}: {json.dumps(per_shape[key])}")
    floor = timer(lambda: torch.cuda._sleep(0))
    log(f"launch floor (an empty kernel, same timer): {floor} ms")
    return dict(per_shape["[16,768] eps 1e-05"], max_abs_err=err,
                shape="[16,768] eps 1e-05 (errors: every shape)",
                launch_floor_ms=floor, shapes=per_shape)


def check_kernels(torch, timer):
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(SEED)
    results = {"layer_norm": check_layer_norm(torch, timer, ln, rng)}

    # single-query paged decode at the main shape; then lens on the
    # kernel's chunk edges (an empty row included), and the engine's own
    # decode lens (timed)
    h, d, bs = PAGED_HEADS, PAGED_DIM, PAGED_BS
    lens = PAGED_LENS
    t, used_blocks = paged_inputs(torch, rng, len(lens), None, h, d, bs,
                                  lens)
    args = (t["q"], t["k"], t["v"], t["tbl"], t["lens"])
    err, split_err = check_paged(torch, pa, args, "main shape")
    results["paged_attention"] = dict(
        time_paged(torch, timer, pa, t, args, bs, used_blocks),
        max_abs_err=err, split_plain_max_abs_err=split_err,
        shape=f"B={len(lens)} H={h} D={d} bs={bs} lens 1..1024 (sum "
              f"{sum(lens)})")
    c = pa.CHUNK_TOKENS
    edge = [c, c + 1, c - 1, 1, 2 * c, 2 * c + 1, 3 * c - 1, 4 * c, 31, 32,
            33, 0, 5 * c + 7]
    te, _ = paged_inputs(torch, rng, len(edge), None, h, d, bs, edge)
    eargs = (te["q"], te["k"], te["v"], te["tbl"], te["lens"])
    e_err, e_split = check_paged(torch, pa, eargs, "chunk-edge lens")
    results["paged_attention"]["max_abs_err"] = max(err, e_err)
    results["paged_attention"]["split_plain_max_abs_err"] = max(split_err,
                                                                e_split)
    results["paged_attention"]["chunk_edge_lens"] = edge
    # the engine's decode: run_serving's prompts half way through their
    # new tokens
    half = SERVING["max_new"] // 2
    engine = sorted(n + half for n in engine_prompt_lens())
    tg, g_used = paged_inputs(torch, rng, len(engine), None, h, d, bs,
                              engine)
    gargs = (tg["q"], tg["k"], tg["v"], tg["tbl"], tg["lens"])
    g_err, g_split = check_paged(torch, pa, gargs, "engine lens")
    results["paged_attention"]["engine_lens"] = dict(
        time_paged(torch, timer, pa, tg, gargs, bs, g_used), lens=engine,
        max_abs_err=g_err, split_plain_max_abs_err=g_split)
    log(f"paged_attention: {json.dumps(results['paged_attention'])}")

    # the multi-query verify window at the main shape (timed); windows
    # straddling chunk edges, a window as long as its context, padded rows
    # and chunks wholly past some rows' limits; Qmax 9 (three row groups);
    # the engine's own verify shape (timed)
    def verify_case(lens, qlens, qmax):
        t, used = paged_inputs(torch, rng, len(lens), qmax, h, d, bs, lens,
                               qlens)
        return t, used, (t["q"], t["qlens"], t["k"], t["v"], t["tbl"],
                         t["lens"])

    qm = VERIFY_QMAX
    t, used_blocks, args = verify_case(lens, VERIFY_QLENS, qm)
    errs = [check_verify(torch, pa, args, "main shape")]
    res = dict(time_verify(torch, timer, pa, t, args, bs, used_blocks),
               shape=f"B={len(lens)} Qmax={qm} H={h} D={d} bs={bs} lens "
                     f"1..1024 (sum {sum(lens)})")
    verify_edge = [c + 1, c + 2, c + 3, c, 2 * c + 1, 2 * c + 2, 3 * c,
                   4 * c + 3, 4, 3, 33, 5 * c + 7]
    edge_qlens = [4, 4, 4, 4, 4, 3, 2, 4, 4, 3, 1, 4]
    errs.append(check_verify(torch, pa, verify_case(
        verify_edge, edge_qlens, qm)[2], "chunk-edge windows"))
    wide = ([9, 130, 300, 1000, 20, 257], [9, 9, 5, 9, 1, 7])
    errs.append(check_verify(torch, pa, verify_case(*wide, 9)[2],
                             "Qmax 9"))
    # the engine's verify: the speculative prompts half way through their
    # new tokens, windows of k + 1
    spec = [n + half for n in engine_prompt_lens()[:SERVING["n_spec"]]]
    ts, s_used, sargs = verify_case(spec, [SPEC_K + 1] * len(spec),
                                    SPEC_K + 1)
    errs.append(check_verify(torch, pa, sargs, "engine verify"))
    res["engine_verify"] = dict(
        time_verify(torch, timer, pa, ts, sargs, bs, s_used), lens=spec,
        max_abs_err=errs[-1][0], split_plain_max_abs_err=errs[-1][1])
    # Qmax == 1 must be bit-identical to the single-query kernel
    one = (t["q"][:, :1].contiguous(), torch.ones_like(t["qlens"]),
           t["k"], t["v"], t["tbl"], t["lens"])
    if not torch.equal(pa.paged_attention_multiquery(*one)[:, 0],
                       pa.paged_attention(one[0][:, 0].contiguous(),
                                          *one[2:])):
        raise AssertionError("multi-query Qmax == 1 is not bit-identical "
                             "to the single-query kernel")
    # every launch leaves the merge tickets it used at zero
    torch.cuda.synchronize()
    if any(int(tk.count_nonzero()) for tk in pa._TICKETS.values()):
        raise AssertionError("paged attention left a merge ticket set")
    res.update(max_abs_err=max(e for e, _ in errs),
               split_plain_max_abs_err=max(e for _, e in errs),
               qmax1_bitwise=True, tickets_zero=True,
               chunk_edge_windows=[verify_edge, edge_qlens], qmax9=wide)
    results["paged_attention_multiquery"] = res
    log(f"paged_attention_multiquery: {json.dumps(res)}")
    return results


# ---------------------------------------------------------------------------
# phase 3, continued: flash attention and the LayerNorm backward
# ---------------------------------------------------------------------------

# (name, B, Tq, Tk, H, D, BTHD layout, causal, key bias, dropout p): the
# two paths' own calls first (seq 512: the dq + dkv route; seq 128: the
# fused route), then masks, ragged lengths, the BHTD layout and the other
# head dims the kernels take
FLASH_CASES = [
    ("path_seq512", 8, 512, 512, 12, 64, True, False, False, 0.1),
    ("path_seq128", 32, 128, 128, 12, 64, True, False, False, 0.1),
    ("seq512_p0", 8, 512, 512, 12, 64, True, False, False, 0.0),
    ("seq512_bias", 8, 512, 512, 12, 64, True, False, True, 0.1),
    ("causal_ragged500", 2, 500, 500, 12, 64, True, True, False, 0.1),
    ("bhtd_causal_bias_200x333", 2, 200, 333, 12, 64, False, True, True, 0.0),
    ("seq128_p0_bias", 32, 128, 128, 12, 64, True, False, True, 0.0),
    ("fused_bhtd_causal_ragged100", 4, 100, 100, 12, 64, False, True, True,
     0.1),
    ("d32_fused", 2, 96, 96, 4, 32, True, False, True, 0.1),
    ("d128_split", 2, 200, 200, 4, 128, False, True, False, 0.1),
    ("d128_fused", 2, 64, 64, 4, 128, True, False, True, 0.1),
    ("d16_split", 2, 130, 130, 2, 16, True, True, True, 0.1),
    # the head dims of the repair: 48, 80, 96, 112 (C = D / 16 of 3, 5, 6,
    # 7), 256 (32-row tiles, always the split route) and 40 (zero-padded
    # to 48 by the flash_attention wrapper, checked through it)
    ("d48_fused", 2, 128, 128, 4, 48, True, False, True, 0.1),
    ("d80_split", 1, 130, 130, 2, 80, True, False, False, 0.1),
    ("d96_split", 2, 150, 150, 4, 96, False, True, False, 0.1),
    ("d96_fused", 2, 64, 64, 4, 96, True, False, True, 0.0),
    ("d112_fused", 1, 60, 60, 2, 112, True, True, False, 0.1),
    ("d256_split_ragged", 2, 100, 100, 2, 256, True, True, True, 0.1),
    ("d256_bhtd", 1, 64, 90, 2, 256, False, False, False, 0.0),
    ("d40_padded_split", 2, 200, 200, 4, 40, True, True, True, 0.1),
    ("d40_padded_fused", 2, 100, 100, 4, 40, False, False, False, 0.1),
    # 384 and 512 (16-row tiles, the split route), and 320 zero-padded to
    # 384 by the wrapper
    ("d384_split_ragged", 2, 100, 100, 2, 384, True, True, True, 0.1),
    ("d512_bhtd", 1, 64, 90, 2, 512, False, False, False, 0.0),
    ("d512_causal_bias", 1, 130, 130, 2, 512, True, True, True, 0.1),
    ("d320_padded", 1, 80, 80, 2, 320, True, False, False, 0.1),
    # above 512: 640 zero-padded to 768 and run as 2 slices of 384 (through
    # the wrapper), 1024 as 2 slices of 512 (the kernels directly)
    ("d640_causal_bias", 1, 100, 100, 2, 640, True, True, True, 0.1),
    ("d1024_bhtd_ragged", 1, 90, 130, 2, 1024, False, False, False, 0.0),
    # phase 11's attentions (Transformer-base, b32, 8 heads of 64): the
    # encoder's self-attention, the decoder's causal self-attention and
    # its attention over the encoder's output (Tq 224 != Tk 256)
    ("mt_encoder_256", 32, 256, 256, 8, 64, True, False, False, 0.1),
    ("mt_decoder_causal_224", 32, 224, 224, 8, 64, True, True, False, 0.1),
    ("mt_cross_224x256", 32, 224, 256, 8, 64, True, False, False, 0.1),
]


def flash_inputs(torch, rng, b, tq, tk, h, d, bthd, bias, p):
    def randn(t):
        shape = (b, t, h, d) if bthd else (b, h, t, d)
        return torch.from_numpy(rng.standard_normal(shape,
                                                    np.float32)).cuda()

    t = {"q": randn(tq), "k": randn(tk), "v": randn(tk), "dout": randn(tq)}
    kw = {"bthd": bthd, "dropout_p": p, "seed": None, "kv_bias": None}
    if p:
        kw["seed"] = torch.tensor([int(rng.integers(0, 2 ** 31 - 1))],
                                  dtype=torch.int32, device="cuda")
    if bias:
        keep = rng.random((b, tk)) < 0.85
        keep[:, 0] = True
        kw["kv_bias"] = torch.from_numpy(np.where(
            keep, 0.0, np.finfo(np.float32).min).astype(np.float32)).cuda()
    return t, kw


def flash_delta(torch, dout, out, bthd):
    delta = (dout * out).sum(dim=-1)
    return (delta.transpose(1, 2) if bthd else delta).contiguous()


def flash_backward(fa, route, args, kw):
    """The backward kernels of ``route`` on ``args`` -> (dq, dk, dv)."""
    if route == "fused":
        return fa.flash_bwd_fused(*args, **kw)
    return (fa.flash_bwd_dq(*args, **kw),) + fa.flash_bwd_dkv(*args, **kw)


def flash_bounds(b, h, tq, tk, d, causal, bias):
    """(bytes, flops, peak) of each flash kernel's function on these
    shapes: inputs read once, outputs written once; flops of the products
    over the score entries a causal or full mask keeps; the peak of the
    unit the kernel runs on (3xTF32 on the tensor cores: every flash
    kernel up to D = 128)."""
    if causal:
        entries = b * h * sum(min(tk, max(0, i + tk - tq + 1))
                              for i in range(tq))
    else:
        entries = b * h * tq * tk
    rows_q, rows_k = b * h * tq * d, b * h * tk * d
    extra = 4 * (b * tk if bias else 0)
    stats = 4 * 2 * b * h * tq  # lse and delta
    return {
        "flash_attention_fwd": (4 * (2 * rows_q + 2 * rows_k + b * h * tq)
                                + extra, 4 * entries * d, PEAK_3XTF32_FLOPS),
        "flash_attention_bwd_dq": (4 * (3 * rows_q + 2 * rows_k) + stats
                                   + extra, 6 * entries * d,
                                   PEAK_3XTF32_FLOPS),
        "flash_attention_bwd_dkv": (4 * (2 * rows_q + 4 * rows_k) + stats
                                    + extra, 8 * entries * d,
                                    PEAK_3XTF32_FLOPS),
        "flash_attention_bwd_fused": (4 * (3 * rows_q + 4 * rows_k) + stats
                                      + extra, 10 * entries * d,
                                      PEAK_3XTF32_FLOPS),
    }


def check_flash(torch, timer):
    """Each flash kernel against the plain version (forward: out and
    lse; backward: autograd of the plain forward) on FLASH_CASES, the
    forward, dq and dK/dV kernels bitwise equal on a second run at the
    seq-512 path's call and the fused backward on every fused-route case;
    times at the two paths' own calls. Returns the kernels' results."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    rng = np.random.default_rng(SEED + 3)
    errs = {n: 0.0 for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv",
                             "flash_attention_bwd_fused")}
    cases, timed = {}, {}
    for name, b, tq, tk, h, d, bthd, causal, bias, p in FLASH_CASES:
        t, kw = flash_inputs(torch, rng, b, tq, tk, h, d, bthd, bias, p)
        kw["causal"] = causal
        q, k, v, dout = t["q"], t["k"], t["v"], t["dout"]
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        pout, plse = fa.flash_attention_plain(*leaves, return_lse=True,
                                              **kw)
        pgrads = torch.autograd.grad(pout, leaves, dout, retain_graph=True)
        pout_v = pout.detach()
        route = fa.backward_route(tq, tk, d)
        padded = fa.kernel_head_dim(d) != d
        if padded:
            # through the wrapper that pads the head dim (lse stays inside)
            kleaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = fa.flash_attention(*kleaves, **kw)
            grads = torch.autograd.grad(out, kleaves, dout)
            out, lse = out.detach(), None
            if route == "fused":
                again = [x.clone().requires_grad_() for x in (q, k, v)]
                regrads = torch.autograd.grad(
                    fa.flash_attention(*again, **kw), again, dout)
        else:
            out, lse = fa.flash_fwd(q, k, v, **kw)
            args = (q, k, v, dout, lse, flash_delta(torch, dout, out, bthd))
            grads = flash_backward(fa, route, args, kw)
            if route == "fused":
                regrads = fa.flash_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
        e = {"out": float((out - pout_v).abs().max())}
        if lse is not None:
            e["lse"] = float((lse - plse).abs().max())
        for g_name, g, pg in zip(("dq", "dk", "dv"), grads, pgrads):
            e[g_name] = float((g - pg).abs().max())
        finite = all(bool(torch.isfinite(x).all())
                     for x in (out, lse) + tuple(grads) if x is not None)
        if route == "fused":
            # deterministic: no atomics, every output written once
            e["fused_bitwise_run_to_run"] = all(
                torch.equal(x, y) for x, y in zip(grads, regrads))
            del regrads
        if name == "path_seq512":
            # deterministic: no atomics, the same sums in the same order
            e["dkv_bitwise_run_to_run"] = all(
                torch.equal(x, y) for x, y in zip(
                    grads[1:], fa.flash_bwd_dkv(*args, **kw)))
            e["fwd_bitwise_run_to_run"] = all(
                torch.equal(x, y) for x, y in zip(
                    (out, lse), fa.flash_fwd(q, k, v, **kw)))
            e["dq_bitwise_run_to_run"] = torch.equal(
                grads[0], fa.flash_bwd_dq(*args, **kw))
        cases[name] = dict(route=route, shape=[b, tq, tk, h, d],
                           kernel_head_dim=fa.kernel_head_dim(d),
                           head_dim_plan=fa.head_dim_plan(d),
                           layout="bthd" if bthd else "bhtd", causal=causal,
                           bias=bias, dropout_p=p, max_abs_err=e)
        log(f"flash {name}: route {route}, errors {json.dumps(e)}")
        bitwise = all(val for key, val in e.items()
                      if key.endswith("_bitwise_run_to_run"))
        if not (finite and bitwise
                and e["out"] <= FLASH_TOL
                and e.get("lse", 0.0) <= FLASH_TOL
                and max(e["dq"], e["dk"], e["dv"]) <= FLASH_GRAD_TOL):
            raise AssertionError(f"flash attention case {name}: kernels "
                                 f"differ from plain: {e} (tolerances "
                                 f"{FLASH_TOL}, {FLASH_GRAD_TOL}), "
                                 f"finite {finite}")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"],
                                          e["out"], e.get("lse", 0.0))
        if route == "fused":
            errs["flash_attention_bwd_fused"] = max(
                errs["flash_attention_bwd_fused"], e["dq"], e["dk"], e["dv"])
        else:
            errs["flash_attention_bwd_dq"] = max(
                errs["flash_attention_bwd_dq"], e["dq"])
            errs["flash_attention_bwd_dkv"] = max(
                errs["flash_attention_bwd_dkv"], e["dk"], e["dv"])
        if name.startswith("path_"):
            timed[name] = time_flash(torch, timer, fa, F, t, kw, pout,
                                     leaves, route, args,
                                     flash_bounds(b, h, tq, tk, d, causal,
                                                  bias))
        del out, lse, pout, pout_v, plse, pgrads, grads, leaves
    results = {}
    for kname, case in (("flash_attention_fwd", "path_seq512"),
                        ("flash_attention_bwd_dq", "path_seq512"),
                        ("flash_attention_bwd_dkv", "path_seq512"),
                        ("flash_attention_bwd_fused", "path_seq128")):
        results[kname] = dict(timed[case][kname], max_abs_err=errs[kname],
                              shape=f"{case}: B,T,H,D = "
                                    f"{cases[case]['shape'][0]},"
                                    f"{cases[case]['shape'][1]},12,64 BTHD,"
                                    f" dropout 0.1")
        log(f"{kname}: {json.dumps(results[kname])}")
    REPORT["flash_cases"] = cases
    REPORT["flash_library"] = {c: timed[c]["library"] for c in timed}
    return results


def time_flash(torch, timer, fa, F, t, kw, pout, leaves, route, args,
               bounds):
    """Times at one path's call: each kernel, the plain version (forward
    under no_grad; backward = autograd through the plain graph) and
    scaled_dot_product_attention at dropout 0 (forward; backward through
    its graph; forward + backward), the yardstick the port never calls.
    """
    q, k, v, dout = t["q"], t["k"], t["v"], t["dout"]
    bthd = kw["bthd"]

    def heads(x):  # SDPA wants [B, H, T, D]
        return (x.transpose(1, 2) if bthd else x).detach()

    sq, sk, sv = (heads(x).clone().requires_grad_() for x in (q, k, v))
    sdout = heads(dout)
    lib_out = F.scaled_dot_product_attention(sq, sk, sv)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(sq, sk, sv)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(sq, sk, sv)
        torch.autograd.grad(o, (sq, sk, sv), sdout)

    def plain_fwd():
        with torch.no_grad():
            fa.flash_attention_plain(q, k, v, **kw)

    lib = {"fwd_ms": timer(lib_fwd),
           "bwd_ms": timer(lambda: torch.autograd.grad(
               lib_out, (sq, sk, sv), sdout, retain_graph=True)),
           "fwd_bwd_ms": timer(lib_fwd_bwd)}
    plain_bwd_ms = timer(lambda: torch.autograd.grad(
        pout, leaves, dout, retain_graph=True), iters=10)
    out = {"library": lib}
    names = ["flash_attention_fwd"] + (
        ["flash_attention_bwd_fused"] if route == "fused"
        else ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    fns = {"flash_attention_fwd": lambda: fa.flash_fwd(q, k, v, **kw),
           "flash_attention_bwd_fused": lambda: fa.flash_bwd_fused(*args,
                                                                   **kw),
           "flash_attention_bwd_dq": lambda: fa.flash_bwd_dq(*args, **kw),
           "flash_attention_bwd_dkv": lambda: fa.flash_bwd_dkv(*args, **kw)}
    for n in names:
        bms, by = bound(*bounds[n])
        fwd = n == "flash_attention_fwd"
        out[n] = {"ms": timer(fns[n]),
                  "plain_ms": timer(plain_fwd, iters=10) if fwd
                  else plain_bwd_ms,
                  "library_ms": lib["fwd_ms"] if fwd else lib["bwd_ms"],
                  "bound_ms": bms, "bound_by": by}
        if bounds[n][2] != PEAK_FP32_FLOPS:
            # the bound of the same work on the FMA units, which the
            # kernel ran on before its redesign
            out[n]["fma_bound_ms"] = bound(*bounds[n][:2])[0]
    return out


def check_layer_norm_backward(torch, timer):
    """The LayerNorm gradient (plain PyTorch, the JAX package's _ln_bwd)
    at BERT's [B*T, 768]: against autograd of the plain forward, and
    through the kernel's autograd Function, whose forward output (the
    kernel's, on inputs that need a gradient, as training calls it) is
    held against the plain forward too; its time, the library's
    (F.layer_norm's backward) and the bound."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    F = torch.nn.functional
    rng = np.random.default_rng(SEED + 5)
    rows, cols, eps = 8 * 512, 768, 1e-12

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(shift + scale * rng.standard_normal(
            shape, np.float32)).cuda()

    x, g = randn(rows, cols), randn(rows, cols)
    w, b = randn(cols, scale=0.1, shift=1.0), randn(cols, scale=0.1)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    plain_out = ln.layer_norm_plain(*leaves, eps)
    want = torch.autograd.grad(plain_out, leaves, g)
    got = ln.layer_norm_backward(x, w, g, eps)
    kleaves = [t.clone().requires_grad_() for t in (x, w, b)]
    kernel_out = ln.layer_norm(*kleaves, eps)
    via_kernel = torch.autograd.grad(kernel_out, kleaves, g)
    fwd_err = float((kernel_out - plain_out).detach().abs().max())
    # relative to each gradient's largest entry: dw and db sum 4096 rows
    err = max(float((a - e).abs().max()) / max(1.0, float(e.abs().max()))
              for a, e in zip(got + via_kernel, want + want))
    if not (fwd_err <= TOL and err <= TOL):
        raise AssertionError(f"layer norm through its autograd Function "
                             f"differs: forward {fwd_err}, backward {err} "
                             f"(relative) > {TOL}")
    lib_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    lib_out = F.layer_norm(lib_leaves[0], (cols,), lib_leaves[1],
                           lib_leaves[2], eps)
    bms, by = bound(4 * (3 * rows * cols + 3 * cols), 12 * rows * cols)
    res = {"shape": f"[{rows},{cols}]", "max_rel_err": err,
           "forward_max_abs_err": fwd_err,
           "ms": timer(lambda: ln.layer_norm_backward(x, w, g, eps)),
           "library_ms": timer(lambda: torch.autograd.grad(
               lib_out, lib_leaves, g, retain_graph=True)),
           "bound_ms": bms, "bound_by": by}
    log(f"layer_norm backward (plain PyTorch): {json.dumps(res)}")
    return res


# (name, B, T, H, D, causal): flash_attention_with_lse's path, BTHD, on
# the dq + dkv route (seq 512, BERT-base's shape) and the fused route
# (seq 128)
LSE_CASES = [("split_seq512", 8, 512, 12, 64, False),
             ("fused_seq128_causal", 32, 128, 12, 64, True)]


def check_flash_lse(torch, timer):
    """flash_attention_with_lse: (out, lse), both differentiable. Its path
    (no caller on the main path yet) runs the entry through its router,
    forward and backward with both cotangents nonzero, on LSE_CASES, with
    the launch counts set to 0 just before and read just after; then each
    output and gradient is held against the plain version
    (flash_attention_with_lse_plain, autograd) within FLASH_TOL /
    FLASH_GRAD_TOL, and the entry (forward + backward) is timed at the
    seq-512 case against the plain version and the bound. Returns (the
    kernels line's result, the path's launch counts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(SEED + 17)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    np.float32)).cuda()

    inputs = {name: ((randn(b, t, h, d), randn(b, t, h, d),
                      randn(b, t, h, d)), randn(b, t, h, d),
                     randn(b, h, t), causal)
              for name, b, t, h, d, causal in LSE_CASES}

    def run(fn, qkv, w1, w2, causal):
        leaves = [x.clone().requires_grad_() for x in qkv]
        o, lse = fn(*leaves, causal=causal)
        grads = torch.autograd.grad((o, lse), leaves, (w1, w2))
        return o.detach(), lse.detach(), grads

    def entry(*x, causal):
        return kernels.maybe_flash_attention_with_lse(*x, causal=causal,
                                                      layout="bthd")

    def plain(*x, causal):
        return fa.flash_attention_with_lse_plain(*x, causal=causal,
                                                 bthd=True)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = {name: run(entry, *inp) for name, inp in inputs.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want_counts = dict({k: 0 for k in counts}, flash_attention_fwd=2,
                       flash_attention_bwd_dq=1, flash_attention_bwd_dkv=1,
                       flash_attention_bwd_fused=1)
    if counts != want_counts:
        raise AssertionError(f"flash_attention_with_lse launches {counts} "
                             f"!= {want_counts}")
    errs, err_out, err_grad = {}, 0.0, 0.0
    for name, inp in inputs.items():
        want = run(plain, *inp)
        e = {"out": float((got[name][0] - want[0]).abs().max()),
             "lse": float((got[name][1] - want[1]).abs().max())}
        for g_name, a, w in zip(("dq", "dk", "dv"), got[name][2], want[2]):
            e[g_name] = float((a - w).abs().max())
        finite = all(bool(torch.isfinite(x).all()) for x in
                     got[name][:2] + tuple(got[name][2]))
        errs[name] = e
        log(f"flash_attention_with_lse {name}: errors {json.dumps(e)}")
        err_out = max(err_out, e["out"], e["lse"])
        err_grad = max(err_grad, e["dq"], e["dk"], e["dv"])
        if not (finite and max(e["out"], e["lse"]) <= FLASH_TOL
                and max(e["dq"], e["dk"], e["dv"]) <= FLASH_GRAD_TOL):
            raise AssertionError(f"flash_attention_with_lse {name}: "
                                 f"differs from plain: {e} (tolerances "
                                 f"{FLASH_TOL}, {FLASH_GRAD_TOL}), finite "
                                 f"{finite}")
        del want
    name, b, t, h, d, causal = LSE_CASES[0]
    inp = inputs[name]
    # the function's own products: S and O forward; dP, dV, dQ, dK back
    entries = b * h * t * t
    bms, by = bound(4 * (4 * b * h * t * d + 4 * b * h * t * d
                         + 2 * b * h * t), 12 * entries * d,
                    PEAK_3XTF32_FLOPS)
    sq, sk, sv = (x.transpose(1, 2).clone().requires_grad_()
                  for x in inp[0])
    sdout = inp[1].transpose(1, 2)

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(sq, sk, sv)
        torch.autograd.grad(o, (sq, sk, sv), sdout)

    def efficient_with_lse():
        # the one PyTorch call that computes (out, lse) in fp32: the
        # memory-efficient attention with compute_log_sumexp (its backward
        # takes the output's cotangent; lse's has no derivative there)
        o, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
            sq, sk, sv, None, True, is_causal=causal)[:2]
        torch.autograd.grad(o, (sq, sk, sv), sdout)

    res = {"ms": timer(lambda: run(entry, *inp), iters=10),
           "plain_ms": timer(lambda: run(plain, *inp), iters=10),
           "library_ms": timer(efficient_with_lse, iters=10),
           "library_call": "aten._scaled_dot_product_efficient_attention("
                           "compute_log_sumexp=True), forward + backward",
           "sdpa_fwd_bwd_ms_without_lse": timer(sdpa, iters=10),
           "bound_ms": bms, "bound_by": by,
           "max_abs_err": max(err_out, err_grad),
           "max_abs_err_outputs": err_out, "max_abs_err_grads": err_grad,
           "cases": errs,
           "shape": f"{name}: B,T,H,D = {b},{t},{h},{d} BTHD, forward + "
                    f"backward with both cotangents (errors: both routes)"}
    log(f"flash_attention_with_lse: {json.dumps(res)}")
    return res, counts


def check_pinned_capture(torch) -> dict:
    """Phase 3, last: PyTorch's pinned allocator records an event on the
    streams a pinned block was copied on when the block is freed; freed
    while one of them is captured, the block leaves an event that fails
    every later pinned allocation of the process ("invalid argument").
    Checks that the side stream of the captured steps is none of 64
    default-priority pool streams (a DeviceLoader's stream), and that a
    fused Adam leaf table built on the side stream, as a warm-up builds
    it, with its frame held past its return and let go inside a capture
    on that stream, leaves a pinned allocation after the capture
    working."""
    import gc
    from paddle_tpu_torch import static
    from paddle_tpu_torch.kernels import fused_adam
    dev = torch.device("cuda")
    side = static._CudaGraphs(dev).stream
    pool = [torch.cuda.Stream(dev) for _ in range(64)]
    aliased = sum(s.cuda_stream == side.cuda_stream for s in pool)
    x = torch.zeros(1 << 12, device=dev)
    rows = ((x.data_ptr(),) * 4 + (x.numel(), 0, 0, 0),)
    held = []

    def hold(frame, event, arg):
        if event == "return" and frame.f_code is fused_adam.leaf_table.__code__:
            held.append(frame)

    sys.setprofile(hold)
    try:
        with torch.cuda.stream(side):
            fused_adam.leaf_table(rows, dev)
    finally:
        sys.setprofile(None)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        y = x * 2
        n_held = len(held)
        held.clear()
        gc.collect()
    del graph, y
    torch.cuda.synchronize()
    try:
        torch.empty(3, pin_memory=True)
        after = "ok"
    except RuntimeError as e:
        after = str(e).splitlines()[0]
    res = {"pool_streams_aliasing_side": aliased, "frames_held": n_held,
           "pinned_alloc_after_capture": after}
    log(f"pinned capture: {json.dumps(res)}")
    if aliased or n_held != 1 or after != "ok":
        raise AssertionError(f"pinned capture: {res}")
    return res


def check_bf16(torch):
    """bf16 operands through each wrapper's cast path on the card (the
    CUDA kernels in fp32 inside), against the plain version on the same
    bf16 inputs: LayerNorm at [4096, 768] (and fp16), flash attention on
    both backward routes, the fused softmax cross-entropy at BERT-base's
    MLM head (bf16 hidden and weight, fp32 bias). Every output and
    gradient dtype is the JAX package's (LN and flash in the input dtype,
    the xent loss fp32, each gradient in its input's dtype); values within
    BF16_TOL of the largest entry (fp32 results: their fp32
    tolerances)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_softmax_xent as fx
    from paddle_tpu_torch.kernels import layer_norm as ln
    rng = np.random.default_rng(SEED + 19)
    bf = torch.bfloat16

    def dev(a, dt=bf):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    def through(fn, args, cot):
        """fn(*args) and the gradients of sum(out * cot) w.r.t. the
        floating args."""
        leaves = [a.clone().requires_grad_() if a.is_floating_point()
                  else a for a in args]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, [x for x in leaves
                                          if x.requires_grad], cot)
        return out.detach(), grads

    def compare(name, got, want, tols, out_absolute=False):
        """Each of out and the gradients within its tolerance of the
        plain version's: relative to the largest entry, or absolute for
        out where ``out_absolute`` (the xent loss, as check_fused_xent
        holds it)."""
        (out, grads), (pout, pgrads) = got, want
        e, dtypes_ok = {}, True
        for what, a, w, tol in zip(("out",) + tuple(
                f"d{i}" for i in range(len(grads))), (out,) + grads,
                (pout,) + pgrads, tols):
            dtypes_ok = dtypes_ok and a.dtype == w.dtype
            e[what] = float((a.float() - w.float()).abs().max()) \
                if what == "out" and out_absolute \
                else rel_err(a.float(), w.float())
            if not (bool(torch.isfinite(a).all()) and e[what] <= tol):
                raise AssertionError(f"bf16 {name}: {what} differs from "
                                     f"plain by {e[what]} > {tol}")
        e["dtypes"] = [str(x.dtype) for x in (out,) + grads]
        if not dtypes_ok:
            raise AssertionError(f"bf16 {name}: dtypes {e['dtypes']} are "
                                 f"not the plain version's")
        log(f"bf16 {name}: {json.dumps(e)}")
        return e

    res = {}
    for dt in (bf, torch.float16):
        args = (dev(rng.standard_normal((4096, 768)), dt),
                dev(1 + 0.1 * rng.standard_normal(768), dt),
                dev(0.1 * rng.standard_normal(768), dt))
        cot = dev(rng.standard_normal((4096, 768)), dt)
        res[f"layer_norm_{str(dt)[6:]}"] = compare(
            f"layer_norm {dt}", through(
                lambda *x: ln.layer_norm(*x, 1e-12), args, cot),
            through(lambda *x: ln.layer_norm_plain(*x, 1e-12), args, cot),
            (BF16_TOL,) * 4)
        if res[f"layer_norm_{str(dt)[6:]}"]["dtypes"] != [str(dt)] * 4:
            raise AssertionError(f"layer_norm {dt}: output or gradient "
                                 f"not in {dt}")
    for case in ("path_seq512", "path_seq128"):
        name, b, tq, tk, h, d, bthd, causal, bias, p = next(
            c for c in FLASH_CASES if c[0] == case)
        t, kw = flash_inputs(torch, rng, b, tq, tk, h, d, bthd, bias, p)
        kw["causal"] = causal
        args = tuple(t[x].to(bf) for x in ("q", "k", "v"))
        cot = t["dout"].to(bf)
        route = fa.backward_route(tq, tk, d)
        e = compare(f"flash {case} ({route})",
                    through(lambda *x: fa.flash_attention(*x, **kw), args,
                            cot),
                    through(lambda *x: fa.flash_attention_plain(*x, **kw),
                            args, cot), (BF16_TOL,) * 4)
        if e["dtypes"] != ["torch.bfloat16"] * 4:
            raise AssertionError(f"flash {case}: output or gradient not "
                                 f"bf16: {e['dtypes']}")
        res[f"flash_{route}"] = e
    name, n, v, hd, bias, ignored = XENT_CASES[0]
    t = xent_inputs(torch, rng, n, v, hd, bias, ignored)
    args = (t["h"].to(bf), t["w"].to(bf), t["b"])
    e = compare("fused_xent", through(
        lambda h_, w_, b_: fx.fused_linear_xent(h_, w_, b_, t["lab"]),
        args, t["g"]), through(
        lambda h_, w_, b_: fx.fused_linear_xent_plain(h_, w_, b_,
                                                      t["lab"]),
        args, t["g"]), (XENT_TOL, BF16_TOL, BF16_TOL, XENT_GRAD_TOL),
        out_absolute=True)
    if e["dtypes"] != ["torch.float32", "torch.bfloat16", "torch.bfloat16",
                       "torch.float32"]:
        raise AssertionError(f"fused xent bf16 dtypes {e['dtypes']}")
    res["fused_xent"] = e
    REPORT["bf16"] = res
    return res


# ---------------------------------------------------------------------------
# phase 3, continued: the fused softmax cross-entropy and the Adam kernel
# ---------------------------------------------------------------------------

# (name, N, V, H, bias, ignored share): the path's call (BERT-base's MLM
# head over b8 x s512 positions; ~15% of rows ignored here, none in the
# training runs) and ragged shapes: N not a tile multiple, V = 513 one
# column past a tile and below one backward chunk, H = 48 not a multiple
# of the 32-wide chunk, no bias; H = 1600 (GPT-2-XL's width, past the old
# shared-memory cap); H = 45 (4-byte copies, unpaired stores); V two
# chunks and 77 columns; every row ignored (all gradients exactly 0)
XENT_CASES = [
    ("path", 4096, 30522, 768, True, 0.15),
    ("ragged_v513_h48_nobias", 1000, 513, 48, False, 0.3),
    ("ragged_n77_v300_h32", 77, 300, 32, True, 0.0),
    ("h1600", 300, 1000, 1600, True, 0.2),
    ("h45_scalar_copies", 130, 300, 45, True, 0.1),
    ("v_two_chunks_and_77", 512, 2 * 2048 + 77, 64, True, 0.1),
    ("all_rows_ignored", 200, 700, 96, True, 1.0),
]
XENT_BWD = ("fused_xent_bwd_dlog", "fused_xent_bwd_dw", "fused_xent_bwd_dh")


def xent_inputs(torch, rng, n, v, hd, bias, ignored):
    """Unit-scale hidden states (a LayerNorm's output), a weight of
    N(0, 0.05) and a bias of N(0, 0.1), so the logits spread over a few
    units; labels uniform with ``ignored`` of them -100; the upstream
    gradient of a mean loss (1 / N per row)."""
    def dev(a):
        return torch.from_numpy(a).cuda()
    lab = rng.integers(0, v, n)
    lab[rng.random(n) < ignored] = -100
    return {"h": dev(rng.standard_normal((n, hd), np.float32)),
            "w": dev((0.05 * rng.standard_normal((v, hd))).astype(
                np.float32)),
            "b": dev((0.1 * rng.standard_normal(v)).astype(np.float32))
            if bias else None,
            "lab": dev(lab.astype(np.int64)),
            "g": torch.full((n,), 1.0 / n, dtype=torch.float32,
                            device="cuda")}


def xent_bounds(n_used, v, hd, n, bias):
    """(bytes, flops, peak) of each xent kernel's function and of the
    backward as a whole: inputs read once, outputs written once; flops of
    the rows whose label is not ignored (an ignored row's loss and
    gradient need no logits). Every product runs in 3xTF32 on the tensor
    cores. Each backward kernel's own function passes the logit gradient
    D ([N, V] over all chunks) between them."""
    ins = 4 * (n * hd + v * hd + (v if bias else 0)) + 8 * n
    dlog = 4 * n * v
    prod = 2 * n_used * v * hd
    return {
        "fused_xent_fwd": (ins + 4 * 2 * n, prod, PEAK_3XTF32_FLOPS),
        "fused_xent_bwd_dlog": (ins + 4 * 2 * n + dlog, prod,
                                PEAK_3XTF32_FLOPS),
        "fused_xent_bwd_dw": (dlog + 4 * (n * hd + v * hd
                                          + (v if bias else 0)), prod,
                              PEAK_3XTF32_FLOPS),
        "fused_xent_bwd_dh": (dlog + 4 * (v * hd + n * hd), prod,
                              PEAK_3XTF32_FLOPS),
        "backward": (ins + 4 * 2 * n + 4 * (n * hd + v * hd
                                            + (v if bias else 0)),
                     3 * prod, PEAK_3XTF32_FLOPS),
    }


def rel_err(got, want) -> float:
    """Largest gap over the reference's largest entry (0 where both are
    exactly 0)."""
    gap = float((got - want).abs().max())
    return 0.0 if gap == 0.0 else gap / max(float(want.abs().max()), 1e-30)


def check_fused_xent(torch, timer):
    """The xent kernels against the plain version on XENT_CASES: forward
    (loss and lse) within XENT_TOL; the chunked backward (dlog, dW/db and
    dh kernels per vocabulary chunk) within XENT_GRAD_TOL of autograd
    through the plain loss and of its chunked plain version
    (fused_xent_bwd_chunked_plain), bitwise equal on a second run and when
    only dh or only dW/db is asked for; every row ignored gives exact
    zeros. Times at the path's call: the forward kernel, each backward
    kernel (torch.profiler, summed over the chunks of one backward), the
    whole backward (CUDA events), the plain versions, the library
    composition (torch.matmul + F.cross_entropy(reduction="none"); its
    backward through autograd) and the bounds."""
    from paddle_tpu_torch.kernels import fused_softmax_xent as fx
    F = torch.nn.functional
    rng = np.random.default_rng(SEED + 7)
    names = ("fused_xent_fwd",) + XENT_BWD
    errs = {k: 0.0 for k in names}
    cases, results = {}, {}
    for name, n, v, hd, bias, ignored in XENT_CASES:
        t = xent_inputs(torch, rng, n, v, hd, bias, ignored)
        h, w, b, lab, g = t["h"], t["w"], t["b"], t["lab"], t["g"]
        loss, lse = fx.xent_fwd(h, w, b, lab)
        loss2, lse2 = fx.xent_fwd(h, w, b, lab)
        args = (h, w, b, lab, lse, g)
        dh, dw, db = fx.xent_bwd(*args)
        again = fx.xent_bwd(*args)
        dh_only = fx.xent_bwd(*args, need_dw=False)[0]
        dw_only, db_only = fx.xent_bwd(*args, need_dh=False)[1:]
        chunked = fx.fused_xent_bwd_chunked_plain(*args)
        leaves = [x.clone().requires_grad_() for x in (h, w, b)
                  if x is not None]
        ploss, plse = fx.fused_linear_xent_plain(
            leaves[0], leaves[1], leaves[2] if bias else None, lab,
            return_lse=True)
        pgrads = torch.autograd.grad(ploss, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        ignored_rows = lab == -100
        used = ~ignored_rows
        got = [x for x in (dh, dw, db) if x is not None]
        e = {"loss": float((loss - ploss.detach()).abs().max()),
             "lse": float((lse - plse)[used].abs().max())
             if bool(used.any()) else 0.0,
             "ignored_loss_exact_0": bool((loss[ignored_rows] == 0).all()),
             "forward_bitwise_run_to_run": torch.equal(loss, loss2)
             and torch.equal(lse, lse2),
             "ignored_dh_exact_0": bool((dh[ignored_rows] == 0).all()),
             "bitwise_run_to_run": all(
                 torch.equal(x, y) for x, y in zip(
                     got, [y for y in again if y is not None])),
             "bitwise_one_gradient": torch.equal(dh, dh_only)
             and torch.equal(dw, dw_only)
             and (db is None or torch.equal(db, db_only))}
        for g_name, x, want, plain in zip(("dh", "dw", "db"), got, pgrads,
                                          chunked):
            e[g_name] = rel_err(x, want)
            e[f"{g_name}_vs_chunked_plain"] = rel_err(x, plain)
        if not bool(used.any()):
            e["all_gradients_exact_0"] = not any(
                bool(x.count_nonzero()) for x in got)
        finite = all(bool(torch.isfinite(x).all())
                     for x in (loss, lse, dh, dw, db) if x is not None)
        cases[name] = dict(shape=[n, v, hd], bias=bias, ignored=ignored,
                           chunk=fx.bwd_chunk(n, v), max_err=e)
        log(f"fused xent {name}: {json.dumps(cases[name])}")
        grad_err = max(val for k, val in e.items()
                       if k.startswith(("dh", "dw", "db")))
        exact = all(val for k, val in e.items() if isinstance(val, bool))
        if not (finite and exact
                and max(e["loss"], e["lse"]) <= XENT_TOL
                and grad_err <= XENT_GRAD_TOL):
            raise AssertionError(f"fused xent case {name}: kernels differ "
                                 f"from plain: {e} (tolerances {XENT_TOL} "
                                 f"absolute, {XENT_GRAD_TOL} of the largest "
                                 f"entry), finite {finite}")
        errs["fused_xent_fwd"] = max(errs["fused_xent_fwd"], e["loss"],
                                     e["lse"])
        for k in XENT_BWD:
            errs[k] = max(errs[k], grad_err)
        if name == "path":
            results = time_xent(torch, timer, fx, F, t, args, ploss, leaves,
                                xent_bounds(int(used.sum()), v, hd, n,
                                            bias))
        del loss, lse, loss2, lse2, dh, dw, db, again, dh_only, dw_only
        del db_only
        del chunked, ploss, plse, pgrads, leaves, args, t, got
    for k in names:
        results[k].update(max_abs_err=errs[k], shape=(
            "N,V,H = 4096,30522,768 with bias, 15% of rows ignored (errors: "
            "every case; backward gradients relative to the largest entry, "
            "the worst of dh, dW, db)"))
        log(f"{k}: {json.dumps(results[k])}")
    REPORT["xent_cases"] = cases
    return results


def xent_kernel_ms(torch, fn, calls: int = 3) -> dict:
    """Device ms per ``fn()`` call of each backward kernel, summed over
    its launches (one per chunk), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in XENT_BWD}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        for k in XENT_BWD:
            if k[len("fused_"):] + "_kernel" in evt.key:
                out[k] += us / 1e3 / calls
    if not all(out.values()):
        raise AssertionError(f"the profiler saw no backward kernel: {out}")
    return out


def time_xent(torch, timer, fx, F, t, args, ploss, leaves, bounds):
    """Times at the path's call: the forward kernel; each backward kernel
    and the whole backward (all three gradients); the plain versions
    (forward under no_grad; the chunked plain backward; autograd through
    the unchunked plain graph); the library composition (torch.matmul +
    F.cross_entropy, reduction none; its backward likewise), which the
    port never calls."""
    h, w, b, lab, g = t["h"], t["w"], t["b"], t["lab"], t["g"]
    lh, lw, lb = (x.clone().requires_grad_() for x in (h, w, b))
    lib_loss = F.cross_entropy(torch.matmul(lh, lw.T) + lb, lab,
                               reduction="none", ignore_index=-100)

    def lib_fwd():
        with torch.no_grad():
            F.cross_entropy(torch.matmul(h, w.T) + b, lab,
                            reduction="none", ignore_index=-100)

    def plain_fwd():
        with torch.no_grad():
            fx.fused_linear_xent_plain(h, w, b, lab)

    plain_bwd = timer(lambda: fx.fused_xent_bwd_chunked_plain(*args),
                      iters=10)
    autograd_bwd = timer(lambda: torch.autograd.grad(
        ploss, leaves, g, retain_graph=True), iters=10)
    lib_bwd = timer(lambda: torch.autograd.grad(
        lib_loss, (lh, lw, lb), g, retain_graph=True), iters=10)
    pair_ms = timer(lambda: fx.xent_bwd(*args), iters=10)
    own = xent_kernel_ms(torch, lambda: fx.xent_bwd(*args))
    pair_bms, pair_by = bound(*bounds["backward"])
    pair = {"ms": pair_ms, "kernels_ms": own, "plain_ms": plain_bwd,
            "plain_unchunked_autograd_ms": autograd_bwd,
            "library_ms": lib_bwd, "bound_ms": pair_bms,
            "bound_by": pair_by, "chunk": fx.bwd_chunk(h.shape[0],
                                                       w.shape[0])}
    log(f"fused xent backward (dlog + dW/db + dh): {json.dumps(pair)}")
    REPORT["xent_backward"] = pair
    out = {}
    bms, by = bound(*bounds["fused_xent_fwd"])
    out["fused_xent_fwd"] = {
        "ms": timer(lambda: fx.xent_fwd(h, w, b, lab), iters=10),
        "plain_ms": timer(plain_fwd, iters=10),
        "library_ms": timer(lib_fwd, iters=10),
        "bound_ms": bms, "bound_by": by}
    for k in XENT_BWD:
        bms, by = bound(*bounds[k])
        out[k] = {"ms": own[k], "plain_ms": plain_bwd,
                  "library_ms": lib_bwd, "bound_ms": bms, "bound_by": by,
                  "backward_ms": pair_ms, "backward_bound_ms": pair_bms}
    return out


def adam_leaves(torch, rng):
    """BERT-base's own parameter leaves (the model built on the card from
    SEED) with a gradient and moments of a run's scale, plus one leaf
    whose data is not 16-byte aligned (the kernel's scalar route). Names
    follow the model's; the decay flag is the JAX bench's AdamW rule
    (``apply_decay_param_fun`` excluding biases and norms)."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    model = BertForPretraining(BertConfig(), device="cuda", seed=SEED)
    leaves = {}
    for name, p in model.named_parameters():
        leaves[name] = p.detach().clone()
    # 1031 elements at a 4-byte offset: scalar loads, a tail of 3, and
    # >= 1024 so the flat variant takes it too
    buf = torch.from_numpy(rng.standard_normal(1032, np.float32)).cuda()
    leaves["unaligned"] = buf[1:]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for name, p in leaves.items():
        def like(scale, square=False):
            a = scale * torch.randn(p.shape, generator=gen, device="cuda")
            return a * a if square else a
        out.append({"name": name, "p": p, "g": like(1e-3),
                    "m": like(1e-4), "v": like(1e-3, square=True),
                    "decay": not (name.endswith("bias") or "norm" in name)})
    del model
    return out


def run_adam(impl, leaves, variant, lr_c, ok, lr_wd=1e-6, wd=0.0,
             keep=lambda leaf: True):
    """One ``impl`` update (adam_multi or adam_multi_plain) of clones of
    the leaves ``keep`` selects; returns their (p, m, v) after it."""
    sel = [leaf for leaf in leaves if keep(leaf)]
    p, m, v = ([leaf[k].clone() for leaf in sel] for k in "pmv")
    impl(p, [leaf["g"] for leaf in sel], m, v,
         [leaf["decay"] for leaf in sel], lr_c, 0.9, 0.999, 1e-8, lr_wd,
         ok, variant, weight_decay=wd)
    return list(zip(p, m, v))


def check_fused_adam(torch, timer):
    """The Adam kernel against its plain version, bitwise, on BERT-base's
    own leaves: the leaf variant over every leaf with AdamW's decay (lr
    1e-4, wd 0.01, biases and norms excluded) with ``ok`` True and with
    ``ok`` False (nothing may be written); the flat variant over the
    leaves of >= 1024 elements (the use_pallas_adam route) and with its
    weight_decay term. Times one launch over the route's leaves against
    the plain version and the bound; torch.optim.AdamW(fused=True) over
    the same leaves is timed beside it as a different function (it puts
    eps on the bias-corrected sqrt(v)), never as the library time."""
    from paddle_tpu_torch.kernels import fused_adam as fa
    rng = np.random.default_rng(SEED + 9)
    leaves = adam_leaves(torch, rng)
    lr_c = torch.tensor([2.34e-5], dtype=torch.float32, device="cuda")
    yes = torch.tensor([True], device="cuda")
    no = torch.tensor([False], device="cuda")
    big = lambda leaf: leaf["p"].numel() >= 1024  # noqa: E731
    checks = {
        "leaf_ok": dict(variant="leaf", ok=yes),
        "leaf_no_guard": dict(variant="leaf", ok=None),
        "leaf_skipped": dict(variant="leaf", ok=no),
        "flat_ge1024": dict(variant="flat", ok=yes, keep=big),
        "flat_weight_decay": dict(variant="flat", ok=yes, keep=big,
                                  wd=0.01),
        # a scheduled rate: lr * wd read on the device
        "leaf_lr_wd_on_device": dict(variant="leaf", ok=yes,
                                     lr_wd=torch.tensor(
                                         [1.3e-6], device="cuda")),
    }
    report = {}
    for name, kw in checks.items():
        got = run_adam(fa.adam_multi, leaves, lr_c=lr_c, **kw)
        want = run_adam(fa.adam_multi_plain, leaves, lr_c=lr_c, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for gl, wl in zip(got, want)
                      for a, b in zip(gl, wl))
        report[name] = {"leaves": len(got), "bitwise": bitwise}
        if name == "leaf_skipped":
            keep = kw.get("keep", lambda leaf: True)
            orig = [(leaf["p"], leaf["m"], leaf["v"]) for leaf in leaves
                    if keep(leaf)]
            report[name]["untouched"] = all(
                torch.equal(a, b) for gl, ol in zip(got, orig)
                for a, b in zip(gl, ol))
            bitwise = bitwise and report[name]["untouched"]
        log(f"fused adam {name}: {json.dumps(report[name])}")
        if not bitwise:
            raise AssertionError(f"fused adam {name}: kernel differs from "
                                 f"plain (bitwise): {report[name]}")
        del got, want
    results = {}
    elems = {}
    for kname, variant, keep in (("adam_leaf", "leaf", lambda leaf: True),
                                 ("adam_flat", "flat", big)):
        sel = [leaf for leaf in leaves if keep(leaf)]
        n = sum(leaf["p"].numel() for leaf in sel)
        elems[kname] = n
        args = ([leaf["p"] for leaf in sel], [leaf["g"] for leaf in sel],
                [leaf["m"] for leaf in sel], [leaf["v"] for leaf in sel],
                [leaf["decay"] for leaf in sel], lr_c, 0.9, 0.999, 1e-8,
                1e-6, yes, variant)
        bms, by = bound(28 * n, 16 * n)
        results[kname] = {
            "ms": timer(lambda: fa.adam_multi(*args), iters=10),
            "plain_ms": timer(lambda: fa.adam_multi_plain(*args), iters=5),
            "library_ms": None,
            "torch_adamw_fused_ms_different_function": time_torch_adamw(
                torch, timer, sel),
            "bound_ms": bms, "bound_by": by, "max_abs_err": 0.0,
            "shape": f"{len(sel) - 1} BERT-base leaves + 1 unaligned, "
                     f"{n} elements; bitwise (all checks)"}
        log(f"{kname}: {json.dumps(results[kname])}")
    REPORT["adam_checks"] = dict(report, elements=elems)
    return results


def time_torch_adamw(torch, timer, sel) -> float:
    """torch.optim.AdamW(fused=True).step() over the same leaves: a
    yardstick of a different function, never called by the port."""
    params = [torch.nn.Parameter(leaf["p"].clone()) for leaf in sel]
    for p, leaf in zip(params, sel):
        p.grad = leaf["g"].clone()
    opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01, fused=True)
    return timer(opt.step, iters=10)


# ---------------------------------------------------------------------------
# phases 4-5: BERT-base pretraining through TrainStep
# ---------------------------------------------------------------------------

def bert_batch(torch, cfg, batch: int, seq: int, device, seed: int):
    """Random token ids, full-position MLM labels and NSP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq))
    mlm = rng.integers(0, cfg.vocab_size, (batch, seq))
    nsp = rng.integers(0, 2, (batch,))
    return tuple(torch.from_numpy(a).to(device) for a in (ids, mlm, nsp))


def expected_launches(seq: int, layers: int, d: int, flags=None,
                      update: bool = True, rows: int = 0,
                      vocab: int = 1) -> dict:
    """Kernel launches of one training step at ``seq``: LN twice per
    layer plus embeddings and the MLM transform, flash forward once per
    layer, and one backward route per layer; under ``fused_softmax_xent``
    the xent forward's two kernels (partials, merge) and, for each
    vocabulary chunk of the backward (``ceil(vocab / bwd_chunk(rows,
    vocab))`` over the ``rows`` MLM positions), dlog, dW/db and dh once;
    with ``update``, one Adam launch for all leaves under ``fused_adam``
    (leaf variant), else under ``use_pallas_adam`` (flat variant, the
    leaves of >= 1024 elements)."""
    from paddle_tpu_torch.kernels.flash_attention import backward_route
    from paddle_tpu_torch.kernels.fused_softmax_xent import bwd_chunk
    flags = flags or {}
    fused = backward_route(seq, seq, d) == "fused"
    xent = 1 if flags.get("fused_softmax_xent") else 0
    chunks = xent * -(-vocab // bwd_chunk(rows, vocab))
    leaf = int(update and bool(flags.get("fused_adam")))
    flat = int(update and not leaf and bool(flags.get("use_pallas_adam")))
    return {"layer_norm": 2 * layers + 2, "paged_attention": 0,
            "paged_attention_multiquery": 0,
            "flash_attention_fwd": layers,
            "flash_attention_bwd_fused": layers if fused else 0,
            "flash_attention_bwd_dq": 0 if fused else layers,
            "flash_attention_bwd_dkv": 0 if fused else layers,
            "fused_xent_fwd": 2 * xent, "fused_xent_bwd_dlog": chunks,
            "fused_xent_bwd_dh": chunks, "fused_xent_bwd_dw": chunks,
            "adam_leaf": leaf,
            "adam_flat": flat}


def make_train_step(model, fused_state=None, loss_fn=None, **kw):
    """The JAX bench's step: AdamW(1e-4, weight_decay=0.01) over
    ``pretraining_loss`` (or ``loss_fn``); ``kw`` to TrainStep."""
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    return TrainStep(model, AdamW(1e-4, weight_decay=0.01,
                                  fused_state=fused_state),
                     loss_fn or pretraining_loss, seed=SEED, **kw)


def check_low_precision_state(torch, step, dtype, what: str) -> dict:
    """Every trainable parameter in ``dtype``, and every master and moment
    fp32 (per leaf, or the flat fused state's)."""
    bad = [n for n, p in step.params.items() if p.dtype != dtype]
    state = step.state
    tensors = dict(state.get("fused", {}))
    for n, slots in state["slots"].items():
        tensors.update({f"{n}.{k}": t for k, t in slots.items()})
    bad += [k for k, t in tensors.items() if t.dtype != torch.float32]
    masters = [k for k in tensors if k.endswith("master")]
    if bad or not masters:
        raise AssertionError(f"{what}: dtypes wrong for {bad[:8]} "
                             f"(masters: {len(masters)})")
    return {"params": len(step.params), "fp32_state_tensors": len(tensors),
            "masters": len(masters), "fused_state": "fused" in state}


def flag_scope(flags: dict):
    """Sets the port's ``flags`` and returns a function restoring their
    previous values."""
    from paddle_tpu_torch import get_flags, set_flags
    old = get_flags(list(flags))
    set_flags(flags)
    return lambda: set_flags(old)


def run_training(torch, model, name: str, batch: int, seq: int,
                 gate: int, flags=None, max_peak_gb=None, fused_state=None,
                 compiled: bool = False):
    """TRAIN_STEPS TrainSteps at (batch, seq) with the flash gate at
    ``gate`` and ``flags`` set, eager or (``compiled``) captured: the
    first step eager, then one capture and a replay per step; launch
    counts set to 0 just before and read just after; the peak device
    memory at most ``max_peak_gb`` GiB where given. A low-precision model
    must keep its dtype and fp32 masters and moments. Returns (stats,
    counts, the step, its batch)."""
    from paddle_tpu_torch import kernels
    cfg = model.config
    data = bert_batch(torch, cfg, batch, seq, "cuda", SEED + seq)
    step = make_train_step(model, fused_state, compiled=compiled)
    restore = flag_scope(dict(flags or {},
                              flash_attention_min_seq_train=gate))
    losses, step_ms = [], []
    try:
        torch.cuda.synchronize()
        # the reserved peak from this run's own blocks, not the last run's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = float(step(data[0], labels=data[1:])["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        counts = kernels.launch_counts()
    finally:
        restore()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    per_step = expected_launches(seq, cfg.num_hidden_layers,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 flags, rows=batch * seq,
                                 vocab=cfg.vocab_size)
    want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != {want} "
                             f"({TRAIN_STEPS} steps of {per_step})")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if max_peak_gb is not None and peak_gb > max_peak_gb:
        raise AssertionError(f"{name}: peak memory {peak_gb} GiB > "
                             f"{max_peak_gb}")
    if compiled and step.captures != 1:
        raise AssertionError(f"{name}: {step.captures} captures over "
                             f"{TRAIN_STEPS} steps of one shape")
    dtype = next(iter(step.params.values())).dtype
    state = None if dtype == torch.float32 else \
        check_low_precision_state(torch, step, dtype, name)
    steady = float(np.median(step_ms[1:]))
    stats = {"batch": batch, "seq": seq, "flags": flags or {},
             "dtype": str(dtype), "fused_state": bool(fused_state),
             "optimizer_state": state, "steps": TRAIN_STEPS,
             "losses": losses, "step_ms": step_ms,
             "step_ms_median_after_first": steady,
             "tokens_per_s": batch * seq / steady * 1e3,
             "launches_per_step": per_step,
             "peak_memory_gb": peak_gb,
             "peak_reserved_gb": torch.cuda.max_memory_reserved() / 2 ** 30,
             "compiled": compiled, "captures": step.captures,
             "capture_ms": step.capture_ms}
    log(f"{name}: {json.dumps(stats)}")
    return stats, counts, step, data


def device_rows(prof, steps: int):
    """torch.profiler device events: [ms per step, launches per step,
    name], largest first (a CPU op's device time repeats its kernels')."""
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append([us / 1e3 / steps, evt.count / steps, evt.key[:90]])
    rows.sort(reverse=True)
    return rows


# the CUDA API calls (cuda* and cu*) by which the host starts device work
HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel",
                     "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def host_launches(prof, steps: int) -> dict:
    """Per step, how often the host called each of HOST_LAUNCH_CALLS
    (torch.profiler's CPU-side runtime events)."""
    out = {}
    for evt in prof.key_averages():
        if evt.key in HOST_LAUNCH_CALLS:
            out[evt.key] = out.get(evt.key, 0) + evt.count / steps
    return out


def profile_train(torch, step, data, gate: int, flags=None) -> dict:
    """Where a training step's time goes: torch.profiler over one step,
    device time by kernel, the device's busy share of the wall time and
    the host's launch calls (one ``cudaGraphLaunch`` for a replay)."""
    from torch.profiler import ProfilerActivity, profile
    restore = flag_scope(dict(flags or {},
                              flash_attention_min_seq_train=gate))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(data[0], labels=data[1:])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    rows = device_rows(prof, 1)
    device_ms = sum(r[0] for r in rows)
    flash = sum(r[0] for r in rows if "flash_" in r[2])
    xent = sum(r[0] for r in rows if "xent_" in r[2])
    adam = sum(r[0] for r in rows if "adam_multi" in r[2])
    ln = sum(r[0] for r in rows if "layer_norm_" in r[2])
    # cuBLAS's kernels: the fp32 SIMT ones carry "gemm"; on Hopper its bf16
    # tensor-core kernels may be named nvjet_* or *xmma*
    gemm = sum(r[0] for r in rows if any(
        k in r[2].lower() for k in ("gemm", "nvjet", "xmma", "cutlass")))
    # the profiler's own host work lengthens the profiled step: the busy
    # share of an unprofiled step is device_ms over that step's wall time
    # (run_training's step_ms)
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if rows else None,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "flash_kernels_ms": flash, "xent_kernels_ms": xent,
            "adam_kernel_ms": adam, "layer_norm_kernel_ms": ln,
            "gemm_ms": gemm,
            "gemm_share": gemm / device_ms if rows else None,
            "device_launches": sum(r[1] for r in rows),
            "host_launch_calls": host_launches(prof, 1),
            "top_ms_launches_name": rows[:15]}


def grad_gaps(torch, grads: dict, ref: dict) -> dict:
    """Each leaf's largest gradient gap over the largest |gradient| of
    its reference. A key-projection bias is measured against its layer's
    k_proj.weight gradient instead: softmax ignores a per-query constant,
    so its exact gradient is 0 and its own entries are fp32 noise, while
    the weight's gradient carries the same dk rows."""
    out = {}
    for n, g in grads.items():
        scale_of = n[:-len("bias")] + "weight" if n.endswith(
            "k_proj.bias") else n
        scale = float(ref[scale_of].abs().max())
        out[n] = float((g.cpu() - ref[n]).abs().max()) / max(scale, 1e-30)
    return out


def cpu_facts(torch) -> dict:
    """The host CPU the CPU side of a card-against-CPU check ran on: its
    model (``/proc/cpuinfo``), torch's thread count and the vector
    instruction set its CPU kernels use."""
    import platform
    model = ""
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.lower().startswith(("model name", "cpu model")):
                    model = ln.split(":", 1)[1].strip()
                    break
    if not model and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True)
        for ln in out.stdout.splitlines():
            if ln.lower().startswith("model name"):
                model = ln.split(":", 1)[1].strip()
                break
    return {"cpu_model": model or platform.processor() or "unknown",
            "cpu_machine": platform.machine(), "cpu_count": os.cpu_count(),
            "cpu_threads": torch.get_num_threads(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def float64_grads(torch, model, ids, mlm, nsp) -> tuple:
    """One forward and backward of ``model`` (cast to float64) on the
    CPU: ``(loss, {name: gradient})``. Raises if any module's floating
    output, the loss or a gradient is not float64 (a silent fp32 step
    would make the reference worthless)."""
    from paddle_tpu_torch.models import pretraining_loss
    narrow = []

    def hook(mod, _inp, out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.is_floating_point() \
                    and o.dtype != torch.float64:
                narrow.append(f"{type(mod).__name__}: {o.dtype}")

    hooks = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        loss = pretraining_loss(model(ids), mlm, nsp)
    finally:
        for h in hooks:
            h.remove()
    names = [n for n, _ in model.named_parameters()]
    grads = {n: g for n, g in zip(names, torch.autograd.grad(
        loss, list(model.parameters()), allow_unused=True))
        if g is not None}
    narrow += [f"grad {n}: {g.dtype}" for n, g in grads.items()
               if g.dtype != torch.float64]
    if loss.dtype != torch.float64 or narrow:
        raise AssertionError(f"the float64 reference ran a step in another "
                             f"dtype: loss {loss.dtype}, {narrow[:10]}")
    return float(loss.detach()), grads


def card_against_cpu(torch, flags=None) -> dict:
    """A 2-layer full-width BERT (dropout 0, batch 2, seq 512) on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch, with ``flags`` set: one forward and backward, whose loss and
    every parameter's gradient must agree (the gradients' size, which one
    Adam step hides); then one TrainStep, after which every parameter
    must agree. Under the default flags a third side runs the same model
    and batch on the CPU in float64 (``nn.layer.to_dtype``; the plain
    versions keep float64 operands in float64): each fp32 side's gradient
    gap to it is reported per leaf, as the check measures gaps, and on a
    failure the five worst leaves say which side lies further from it."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         pretraining_loss)
    from paddle_tpu_torch.nn.layer import to_dtype
    cfg = BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    cpu = BertForPretraining(cfg, device="cpu", seed=SEED)
    card = BertForPretraining(cfg, device="cuda", seed=SEED)
    card.load_state_dict(cpu.state_dict())
    data = bert_batch(torch, cfg, 2, 512, "cpu", SEED + 11)
    facts = cpu_facts(torch)
    log(f"card vs cpu: host {json.dumps(facts)}")
    ref64 = None
    if not flags:
        f64 = BertForPretraining(cfg, device="cpu", seed=SEED)
        f64.load_state_dict(cpu.state_dict())
        to_dtype(f64, torch.float64)
        t0 = time.perf_counter()
        ref64 = float64_grads(torch, f64, *data)
        log(f"card vs cpu: float64 side {time.perf_counter() - t0:.2f} s, "
            f"loss {ref64[0]}")
        del f64
    grad_losses, losses, grads, counts = {}, {}, {}, {}
    restore = flag_scope(flags or {})
    try:
        for dev, model in (("cuda", card), ("cpu", cpu)):
            ids, mlm, nsp = (x.to(dev) for x in data)
            names = [n for n, _ in model.named_parameters()]
            kernels.reset_launch_counts()
            loss = pretraining_loss(model(ids), mlm, nsp)
            # without token type ids their embedding gets no gradient
            grads[dev] = {n: g for n, g in zip(names, torch.autograd.grad(
                loss, list(model.parameters()), allow_unused=True))
                if g is not None}
            counts[f"grad_{dev}"] = kernels.launch_counts()
            grad_losses[dev] = float(loss.detach())
            step = make_train_step(model, compiled=False)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            losses[dev] = float(step(ids, labels=(mlm, nsp))["loss"])
            counts[f"step_{dev}"] = kernels.launch_counts()
            log(f"card vs cpu {flags or 'default flags'}: {dev} step "
                f"{time.perf_counter() - t0:.2f} s, loss {losses[dev]}")
    finally:
        restore()
    rel = grad_gaps(torch, grads["cuda"], grads["cpu"])
    worst_grad = max(rel, key=rel.get)
    params_cpu = dict(cpu.named_parameters())
    gaps = {n: (p.detach().cpu() - params_cpu[n].detach()).abs()
            for n, p in card.named_parameters()}
    diffs = {n: float(g.max()) for n, g in gaps.items()}
    worst = max(diffs, key=diffs.get)
    res = {"flags": flags or {}, **facts,
           "loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
           "loss_rel_diff": max(abs(a["cuda"] - a["cpu"]) / abs(a["cpu"])
                                for a in (grad_losses, losses)),
           "grad_max_rel_gap": rel[worst_grad], "worst_grad": worst_grad,
           "grad_rel_gap_by_leaf": rel, "grads_compared": len(rel),
           "param_max_abs_diff": diffs[worst], "worst_param": worst,
           "param_mean_abs_diff": float(sum(g.sum() for g in gaps.values())
                                        / sum(g.numel()
                                              for g in gaps.values())),
           "k_proj_bias_max_abs_diff": max(
               d for n, d in diffs.items() if n.endswith("k_proj.bias")),
           "params_compared": len(diffs),
           "launches": counts}
    worst5 = sorted(rel, key=rel.get, reverse=True)[:5]
    if ref64 is not None:
        to64 = {side: grad_gaps(torch, grads[side], ref64[1])
                for side in ("cuda", "cpu")}
        res.update(
            loss_float64=ref64[0],
            grad_gap_to_float64_by_leaf={
                n: {"cuda": to64["cuda"][n], "cpu": to64["cpu"][n]}
                for n in rel},
            grad_max_gap_to_float64={side: max(g.values())
                                     for side, g in to64.items()},
            worst_leaves=[{"leaf": n, "gap": rel[n],
                           "cuda_to_float64": to64["cuda"][n],
                           "cpu_to_float64": to64["cpu"][n],
                           "further_from_float64":
                               "cuda" if to64["cuda"][n] > to64["cpu"][n]
                               else "cpu"} for n in worst5])
        log(f"card vs cpu: gradient gap to float64, largest per side "
            f"{json.dumps(res['grad_max_gap_to_float64'])}")
    log(f"card vs cpu: {json.dumps({k: v for k, v in res.items() if not k.endswith('_by_leaf')})}")  # noqa: E501
    kw = dict(rows=2 * 512, vocab=cfg.vocab_size)
    want = {"grad": expected_launches(512, 2, 64, flags, update=False,
                                      **kw),
            "step": expected_launches(512, 2, 64, flags, **kw)}
    if any(counts[f"{what}_cuda"] != want[what]
           or any(counts[f"{what}_cpu"].values())
           for what in ("grad", "step")):
        raise AssertionError(f"card vs cpu launches: {counts} (card "
                             f"should be {want}, cpu all 0)")
    if not (res["loss_rel_diff"] <= STEP_LOSS_RTOL
            and res["grad_max_rel_gap"] <= GRAD_REL_TOL
            and res["param_max_abs_diff"] <= STEP_PARAM_TOL):
        for w in res.get("worst_leaves", []):
            log(f"card vs cpu: worst leaf {json.dumps(w)}")
        raise AssertionError(f"card and CPU disagree: {res} (tolerances "
                             f"{STEP_LOSS_RTOL} loss relative, "
                             f"{GRAD_REL_TOL} gradient relative, "
                             f"{STEP_PARAM_TOL} parameters)")
    return res


def host_copy(tensors: dict) -> dict:
    """Copies of ``tensors`` in host memory (a snapshot kept on the card
    would add to the next run's peak device memory)."""
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def end_state(step) -> dict:
    """Host copies of a step's parameters and, for a low-precision model,
    of its fp32 masters (``master.<name>``)."""
    out = dict(step.params)
    if next(iter(step.params.values())).element_size() < 4:
        out.update({f"master.{n}": m for n, m in master_dict(step).items()})
    return host_copy(out)


def captured_against_eager(torch, eager: dict, captured: dict,
                           eager_end: dict, captured_end: dict,
                           lr: float = 1e-4) -> dict:
    """A captured run against the eager run from the same weights, seed
    and batches: every step's loss and every parameter (and fp32 master)
    after the last step. Bit for bit, or else within the card-against-CPU
    limits: fp32 STEP_LOSS_RTOL and STEP_PARAM_TOL; bf16
    BF16_STEP_LOSS_RTOL, at most BF16_MASTER_SHARE of master entries
    beyond lr/2 and none beyond BF16_MASTER_MAX_LR lr a step. Raises
    otherwise; returns the gaps."""
    steps = len(eager["losses"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
        captured["losses"], eager["losses"]))
    gaps = {k: (captured_end[k].float() - t.float()).abs()
            for k, t in eager_end.items()}
    params = [k for k in gaps if not k.startswith("master.")]
    masters = [k for k in gaps if k.startswith("master.")]
    res = {"steps": steps,
           "losses_equal": captured["losses"] == eager["losses"],
           "params_equal": all(float(gaps[k].max()) == 0.0 for k in gaps),
           "loss_max_rel_gap": loss_gap,
           "param_max_abs_gap": max(float(gaps[k].max()) for k in params),
           "tensors_compared": len(gaps)}
    res["bitwise"] = res["losses_equal"] and res["params_equal"]
    if masters:
        total = sum(gaps[k].numel() for k in masters)
        res["master_share_over_half_lr"] = sum(
            int((gaps[k] > lr / 2).sum()) for k in masters) / total
        res["master_max_gap_over_lr"] = max(
            float(gaps[k].max()) for k in masters) / lr
        ok = (loss_gap <= BF16_STEP_LOSS_RTOL
              and res["master_share_over_half_lr"] <= BF16_MASTER_SHARE
              and res["master_max_gap_over_lr"]
              <= BF16_MASTER_MAX_LR * steps)
    else:
        ok = loss_gap <= STEP_LOSS_RTOL \
            and res["param_max_abs_gap"] <= STEP_PARAM_TOL
    if not (res["bitwise"] or ok):
        raise AssertionError(f"captured and eager steps disagree: {res}")
    return res


def run_train_set(torch, model, runs: dict, report: dict,
                  counts: dict) -> None:
    """Each run of ``runs`` on ``model`` in turn (run_training): eager,
    then its captured twin (``<name>_captured``) from the same weights,
    seed and batches, held against it (captured_against_eager); the
    PROFILED_RUNS and every twin profiled after their steps (a twin whose
    profile shows no device time takes the eager run's device time, the
    same kernels). Fills ``report`` and ``counts``."""
    for name, run in runs.items():
        start = host_copy(dict(model.named_parameters()))
        stats, counts[name], step, data = run_training(torch, model, name,
                                                       **run)
        report[name] = stats
        eager_end = end_state(step)
        if name in PROFILED_RUNS:
            report[f"profile_{name}"] = profile_run(torch, step, data, run,
                                                    stats, name)
        del step, data
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        del start
        twin = name + CAPTURED
        cstats, counts[twin], step, data = run_training(
            torch, model, twin, compiled=True, **run)
        report[twin] = cstats
        vs = captured_against_eager(torch, stats, cstats, eager_end,
                                    end_state(step))
        report[f"{twin}_vs_eager"] = vs
        log(f"{twin} against eager: {json.dumps(vs)}")
        del eager_end
        prof = profile_run(torch, step, data, run, cstats, twin)
        eager_prof = report.get(f"profile_{name}")
        if not prof["device_ms"] and eager_prof and eager_prof["device_ms"]:
            prof["device_ms_from_eager_run"] = eager_prof["device_ms"]
            prof["device_busy_share_unprofiled"] = \
                eager_prof["device_ms"] / cstats["step_ms_median_after_first"]
        report[f"profile_{twin}"] = prof
        del step, data


def profile_run(torch, step, data, run: dict, stats: dict,
                name: str) -> dict:
    """profile_train of one more step of ``step``, with the busy share of
    the unprofiled steps (device ms over their median wall ms)."""
    prof = profile_train(torch, step, data, run["gate"], run.get("flags"))
    if prof["device_ms"]:
        prof["device_busy_share_unprofiled"] = \
            prof["device_ms"] / stats["step_ms_median_after_first"]
    log(f"train profile ({name}): {json.dumps(prof)}")
    return prof


def run_training_phases(torch) -> tuple:
    """Phases 4-5 and the bf16 phases. Returns (report, launch counts of
    each training run)."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    report, counts = {}, {}
    model = BertForPretraining(BertConfig(), device="cuda", seed=SEED)
    run_train_set(torch, model, TRAIN_RUNS, report, counts)
    del model
    torch.cuda.empty_cache()
    report["card_against_cpu"] = card_against_cpu(torch)
    report["card_against_cpu_fused"] = card_against_cpu(torch, FUSED_FLAGS)
    model = cast_model_to_low_precision(
        BertForPretraining(BertConfig(), device="cuda", seed=SEED),
        "bfloat16")
    run_train_set(torch, model, BF16_RUNS, report, counts)
    del model
    torch.cuda.empty_cache()
    report["card_against_cpu_bf16"] = card_against_cpu_bf16(torch)
    report["card_against_cpu_bf16_fused"] = card_against_cpu_bf16(
        torch, FUSED_FLAGS, fused_state=True)
    report["grad_scaler"] = check_grad_scaler(torch)
    report["grad_scaler_captured"] = check_grad_scaler(torch, compiled=True)
    report["run_steps_eval"] = check_run_steps_and_eval(torch)
    report["captured_host_lr_and_shapes"] = \
        check_captured_host_lr_and_shapes(torch)
    return report, counts


# ---------------------------------------------------------------------------
# phase 5b: bf16 and fp16 through TrainStep on a 2-layer full-width BERT
# ---------------------------------------------------------------------------

def small_bert(torch, device: str, dtype):
    """The 2-layer full-width BERT (dropout 0) from SEED, cast to
    ``dtype`` as the JAX bench casts (parameters only)."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    cfg = BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    return cast_model_to_low_precision(
        BertForPretraining(cfg, device=device, seed=SEED), dtype)


def padded_batch(torch, cfg, device, seed: int):
    """bert_batch at batch 2, seq 512, with an attention mask that pads
    the second row from position 384 (its keys reach the flash kernels as
    a -inf bias)."""
    ids, mlm, nsp = bert_batch(torch, cfg, 2, 512, device, seed)
    mask = torch.ones(2, 512, dtype=torch.int64, device=device)
    mask[1, 384:] = 0
    return ids, mask, mlm, nsp


def card_against_cpu_bf16(torch, flags=None, fused_state=None) -> dict:
    """The 2-layer full-width BERT in bf16 (dropout 0, batch 2, seq 512,
    a padded row) on the card (kernels through their cast path) and on
    the CPU (plain versions) from the same bf16 weights, with ``flags``:
    one forward and backward, whose loss and every bf16 gradient must
    agree within the BF16_* tolerances; then one TrainStep (fp32 masters
    and moments, ``fused_state``), after which the loss and the masters
    must agree. The card must launch what expected_launches says, the
    CPU nothing."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import pretraining_loss
    cpu = small_bert(torch, "cpu", "bfloat16")
    card = small_bert(torch, "cuda", "bfloat16")
    card.load_state_dict(cpu.state_dict())
    cfg = cpu.config
    data = padded_batch(torch, cfg, "cpu", SEED + 13)
    losses, grad_losses, grads, masters, counts, state = {}, {}, {}, {}, \
        {}, {}
    restore = flag_scope(flags or {})
    try:
        for dev, model in (("cuda", card), ("cpu", cpu)):
            ids, mask, mlm, nsp = (x.to(dev) for x in data)
            names = [n for n, _ in model.named_parameters()]
            kernels.reset_launch_counts()
            loss = pretraining_loss(model(ids, attention_mask=mask), mlm,
                                    nsp)
            grads[dev] = {n: g for n, g in zip(names, torch.autograd.grad(
                loss, list(model.parameters()), allow_unused=True))
                if g is not None}
            counts[f"grad_{dev}"] = kernels.launch_counts()
            grad_losses[dev] = float(loss.detach())
            step = make_train_step(model, fused_state, compiled=False)
            kernels.reset_launch_counts()
            losses[dev] = float(step(ids, attention_mask=mask,
                                     labels=(mlm, nsp))["loss"])
            counts[f"step_{dev}"] = kernels.launch_counts()
            state[dev] = check_low_precision_state(
                torch, step, torch.bfloat16, f"card vs cpu bf16 {dev}")
            masters[dev] = master_dict(step)
    finally:
        restore()
    if any(g.dtype != torch.bfloat16 for d in grads.values()
           for g in d.values()):
        raise AssertionError("card vs cpu bf16: a gradient is not bf16")
    rel = grad_gaps(torch, grads["cuda"], grads["cpu"])
    worst_grad = max(rel, key=rel.get)
    lr = 1e-4
    gaps = {n: (m.cpu() - masters["cpu"][n]).abs()
            for n, m in masters["cuda"].items()}
    total = sum(g.numel() for g in gaps.values())
    share = sum(int((g > lr / 2).sum()) for g in gaps.values()) / total
    worst = max(gaps, key=lambda n: float(gaps[n].max()))
    res = {"flags": flags or {}, "fused_state": bool(fused_state),
           "loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
           "loss_rel_diff": max(abs(a["cuda"] - a["cpu"]) / abs(a["cpu"])
                                for a in (grad_losses, losses)),
           "grad_max_rel_gap": rel[worst_grad], "worst_grad": worst_grad,
           "grad_rel_gap_by_leaf": rel,
           "master_share_over_half_lr": share,
           "master_max_diff_over_lr": float(gaps[worst].max()) / lr,
           "worst_master": worst, "master_entries": total,
           "state": state["cuda"], "launches": counts}
    log(f"card vs cpu bf16: {json.dumps({k: v for k, v in res.items() if k != 'grad_rel_gap_by_leaf'})}")
    kw = dict(rows=2 * 512, vocab=cfg.vocab_size)
    want = {"grad": expected_launches(512, 2, 64, flags, update=False,
                                      **kw),
            "step": expected_launches(512, 2, 64, flags, **kw)}
    if any(counts[f"{what}_cuda"] != want[what]
           or any(counts[f"{what}_cpu"].values())
           for what in ("grad", "step")):
        raise AssertionError(f"card vs cpu bf16 launches: {counts} (card "
                             f"should be {want}, cpu all 0)")
    if not (res["loss_rel_diff"] <= BF16_STEP_LOSS_RTOL
            and res["grad_max_rel_gap"] <= BF16_GRAD_TOL
            and share <= BF16_MASTER_SHARE
            and res["master_max_diff_over_lr"] <= BF16_MASTER_MAX_LR):
        raise AssertionError(
            f"bf16 card and CPU disagree: {res} (tolerances "
            f"{BF16_STEP_LOSS_RTOL} loss relative, {BF16_GRAD_TOL} "
            f"gradient relative, {BF16_MASTER_SHARE} of masters beyond "
            f"lr/2, none beyond {BF16_MASTER_MAX_LR} lr)")
    return res


def master_dict(step) -> dict:
    """Each parameter's fp32 master by name (its slice of the flat
    master under fused_state)."""
    state = step.state
    if "fused" not in state:
        return {n: s["master"] for n, s in state["slots"].items()}
    flat, out, off = state["fused"]["master"], {}, 0
    for n in sorted(step.params):
        k = step.params[n].numel()
        out[n] = flat[off:off + k]
        off += k
    return out


def snapshot(step) -> dict:
    """Clones of a step's parameters, optimizer state and scaler state."""
    state = step.state
    out = {f"param.{n}": p.detach().clone() for n, p in step.params.items()}
    out["opt.step"] = state["step"].clone()
    for n, slots in state["slots"].items():
        out.update({f"opt.{n}.{k}": t.clone() for k, t in slots.items()})
    out.update({f"opt.fused.{k}": t.clone()
                for k, t in state.get("fused", {}).items()})
    out.update({f"scaler.{k}": t.clone()
                for k, t in (step.scaler_state or {}).items()})
    return out


def check_grad_scaler(torch, compiled: bool = False) -> dict:
    """One fp16 TrainStep(amp_dtype="float16", scaler=GradScaler()) on the
    2-layer full-width BERT cast to fp16, fed a poisoned batch (the loss
    times inf) twice: after each, the parameters, fp32 masters, moments
    and step counter are bit for bit what they were, the scale halves at
    the second (decr_every_n_nan_or_inf = 2), and neither step
    synchronises with the host (CUDA sync debug mode "error" raises on
    any synchronising call). Then clean steps until one applies.
    ``compiled``: the captured step, whose first step (eager, then the
    capture, which synchronises) takes the poisoned batch before the
    sync check; the two poisoned steps checked are replays (the scale
    halves at the first of them, the second poisoned step), as are the
    clean ones."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models import pretraining_loss
    model = small_bert(torch, "cuda", "float16")
    ids, mask, mlm, nsp = padded_batch(torch, model.config, "cuda",
                                       SEED + 17)
    scaler = GradScaler()
    step = make_train_step(
        model, loss_fn=lambda out, m, n, s: pretraining_loss(out, m, n) * s,
        amp_dtype="float16", scaler=scaler, compiled=compiled)
    poison = torch.tensor(float("inf"), device="cuda")
    one = torch.tensor(1.0, device="cuda")
    before = snapshot(step)
    torch.cuda.synchronize()
    scales = []

    def poisoned() -> None:
        step(ids, attention_mask=mask, labels=(mlm, nsp, poison))
        scales.append({k: v.clone() for k, v in step.scaler_state.items()})
    if compiled:
        poisoned()
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(scaler.decr_every_n_nan_or_inf):
            poisoned()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = snapshot(step)
    changed = [k for k in before if not k.startswith("scaler.")
               and not torch.equal(before[k], after[k])]
    got = [{k: float(v) for k, v in s.items()} for s in scales]
    init = scaler.init_loss_scaling
    want = [{"scale": init, "good_steps": 0.0, "bad_steps": 1.0},
            {"scale": init * scaler.decr_ratio, "good_steps": 0.0,
             "bad_steps": 0.0}]
    if compiled:
        want.append({"scale": init * scaler.decr_ratio, "good_steps": 0.0,
                     "bad_steps": 1.0})
    res = {"compiled": compiled, "unchanged": not changed,
           "scaler_states": got,
           "nonfinite_steps": int(step.nonfinite_steps),
           "state_tensors": len(before), "sync_free": True}
    # clean steps until one applies: an fp16 gradient that overflows at
    # the scale skips its step too, and the scale halves every second one
    scale_log = []
    while int(step.state["step"]) == 0 and len(scale_log) < 10:
        scale_log.append(float(step.scaler_state["scale"]))
        res["clean_loss"] = float(step(ids, attention_mask=mask,
                                       labels=(mlm, nsp, one))["loss"])
    res.update(clean_steps_to_apply=len(scale_log),
               scale_at_clean_steps=scale_log, captures=step.captures,
               params_moved=not all(torch.equal(p, before[f"param.{n}"])
                                    for n, p in step.params.items()))
    log(f"grad scaler (fp16{', captured' if compiled else ''}): "
        f"{json.dumps(res)}")
    if changed or got != want or res["nonfinite_steps"] != len(want):
        raise AssertionError(f"grad scaler: changed {changed[:8]}, scaler "
                             f"states {got} (want {want}), "
                             f"{res['nonfinite_steps']} non-finite steps")
    if int(step.state["step"]) != 1 or not res["params_moved"] \
            or not np.isfinite(res["clean_loss"]) or not all(
                bool(torch.isfinite(p).all()) for p in step.params.values()):
        raise AssertionError(f"grad scaler: no clean step applied in "
                             f"{len(scale_log)} or it left non-finite "
                             f"values: {res}")
    if step.captures != int(compiled):
        raise AssertionError(f"grad scaler: {step.captures} captures")
    return res


def check_run_steps_and_eval(torch) -> dict:
    """run_steps over K = 3 stacked batches against three calls of a twin
    step from the same bf16 weights, eager and captured (one capture
    each, after the first step): the same losses, extra metric and
    parameters bit for bit; then an EvalStep forward, equal to the
    model's own eval-mode forward, finite, in bf16, the training mode
    restored after."""
    from paddle_tpu_torch.static import EvalStep
    res = {}
    for compiled in (False, True):
        models = [small_bert(torch, "cuda", "bfloat16") for _ in range(2)]
        models[1].load_state_dict(models[0].state_dict())
        cfg = models[0].config
        batches = [padded_batch(torch, cfg, "cuda", SEED + 21 + i)
                   for i in range(3)]
        metric = {"nsp_logit_mean": lambda out, m, n: out[1].float().mean()}
        calls, multi = (make_train_step(m, extra_metrics=metric,
                                        compiled=compiled)
                        for m in models)
        want = [calls(ids, attention_mask=mask, labels=(mlm, nsp))
                for ids, mask, mlm, nsp in batches]
        ids, mask, mlm, nsp = (torch.stack(parts) for parts in zip(*batches))
        got = multi.run_steps(ids, attention_mask=mask, labels=(mlm, nsp))
        key = "captured_" if compiled else ""
        res[f"{key}run_steps_losses"] = got["loss"].tolist()
        res[f"{key}calls_losses"] = [float(w["loss"]) for w in want]
        res[f"{key}same_metrics"] = all(
            torch.equal(got[k], torch.stack([w[k] for w in want]))
            for k in ("loss", "nsp_logit_mean"))
        res[f"{key}same_params"] = all(torch.equal(a, b) for a, b in zip(
            models[0].parameters(), models[1].parameters()))
        res[f"{key}captures"] = [calls.captures, multi.captures]
        if res[f"{key}captures"] != [int(compiled)] * 2:
            raise AssertionError(f"run_steps: captures {res}")
    ids, mask, mlm, nsp = batches[0]
    model = models[0]
    out, metrics = EvalStep(model, {"nsp_acc": lambda o, n: (
        o[1].argmax(-1) == n).float().mean()})(None, None, ids, None, mask,
                                               labels=(nsp,))
    restored = model.training
    model.eval()
    with torch.no_grad():
        ref = model(ids, None, mask)
    model.train()
    res.update({
        "eval_equal": all(torch.equal(a, b) for a, b in zip(out, ref)),
        "eval_finite": all(bool(torch.isfinite(o.float()).all())
                           for o in out),
        "eval_dtype": str(out[0].dtype), "eval_nsp_acc": float(
            metrics["nsp_acc"]), "training_restored": restored})
    log(f"run_steps and EvalStep: {json.dumps(res)}")
    if not (res["same_metrics"] and res["same_params"]
            and res["captured_same_metrics"] and res["captured_same_params"]
            and res["eval_equal"] and res["eval_finite"]
            and out[0].dtype == torch.bfloat16 and restored):
        raise AssertionError(f"run_steps / EvalStep: {res}")
    return res


def check_captured_host_lr_and_shapes(torch) -> dict:
    """The captured step against the eager one on a 2-layer full-width
    BERT (fp32, dropout 0.1) trained with a host-driven ReduceOnPlateau:
    two steps at 1e-4, its rate changed to 5e-5 between two replays, two
    more, then two steps of another batch shape (seq 256), which must
    take a second capture. Every loss and parameter must equal the eager
    twin's (within the fp32 card-against-CPU limits), and a third step
    held at 1e-4 must end elsewhere: the change reached the update.
    Dropping the steps must free the captured one at once, its graphs
    and their pools with it."""
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         pretraining_loss)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import ReduceOnPlateau
    from paddle_tpu_torch.static import TrainStep
    cfg = BertConfig(num_hidden_layers=2)
    models = [BertForPretraining(cfg, device="cuda", seed=SEED)
              for _ in range(3)]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    scheds = [ReduceOnPlateau(1e-4), ReduceOnPlateau(1e-4), None]
    steps = [TrainStep(m, AdamW(s or 1e-4, weight_decay=0.01),
                       pretraining_loss, seed=SEED, compiled=c)
             for m, s, c in zip(models, scheds, (False, True, True))]
    plan = [(512, 1e-4)] * 2 + [(512, 5e-5)] * 2 + [(256, 5e-5)] * 2
    losses = [[], [], []]
    for i, (seq, rate) in enumerate(plan):
        ids, mlm, nsp = bert_batch(torch, cfg, 2, seq, "cuda", SEED + 30 + i)
        for s in scheds[:2]:
            s.current_lr = rate
        for k, step in enumerate(steps):
            losses[k].append(float(step(ids, labels=(mlm, nsp))["loss"]))
    eager, captured, held = ({"losses": ls} for ls in losses)
    ends = [end_state(s) for s in steps]
    vs = captured_against_eager(torch, eager, captured, ends[0], ends[1])
    moved = not all(torch.equal(a, ends[2][k]) for k, a in ends[1].items())
    res = {"plan": plan, "captured_vs_eager": vs,
           "captures": steps[1].captures, "held_captures": steps[2].captures,
           "held_run_differs": moved,
           "host_lr_after": float(steps[1].host_lr),
           "losses": losses}
    # a dropped step frees its graphs and their memory pools at once (no
    # reference cycle keeps it alive)
    alive = weakref.ref(steps[1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    del steps
    torch.cuda.empty_cache()
    res.update(dropped_step_freed=alive() is None,
               reserved_freed_gb=(before - torch.cuda.memory_reserved())
               / 2 ** 30)
    log(f"captured host lr and shapes: {json.dumps(res)}")
    if res["captures"] != 2 or not moved \
            or res["host_lr_after"] != float(np.float32(5e-5)) \
            or not res["dropped_step_freed"]:
        raise AssertionError(f"captured host lr / shapes: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 5c: fed, resumed and evaluated: the DataLoader with workers and the
# pinned DeviceLoader, a checkpoint saved while training goes on and
# restored into a fresh step, the captured EvalStep
# ---------------------------------------------------------------------------

class PretrainSamples:
    """Synthetic BERT pretraining samples from a seed, as the JAX bench
    feeds them (``bench.py``): token ids, segment ids (the second
    sentence from a random split), an attention mask (a padded tail of
    up to a quarter of the sequence), ``RESUME_MASKED`` sorted masked
    positions within the unpadded part, their MLM labels and an NSP
    label; numpy, int64. A map-style dataset (``paddle_tpu_torch.data.
    Dataset``'s protocol)."""

    def __init__(self, n: int, seq: int, vocab: int, seed: int) -> None:
        rng = np.random.default_rng(seed)
        lens = rng.integers(seq * 3 // 4, seq + 1, n)
        self.ids = rng.integers(0, vocab, (n, seq))
        split = rng.integers(seq // 4, seq * 3 // 4, n)
        self.types = (np.arange(seq)[None, :] >= split[:, None]).astype(
            np.int64)
        self.mask = (np.arange(seq)[None, :] < lens[:, None]).astype(
            np.int64)
        self.ids *= self.mask
        self.pos = np.stack([np.sort(rng.choice(n_, RESUME_MASKED,
                                                replace=False))
                             for n_ in lens]).astype(np.int64)
        self.mlm = np.take_along_axis(self.ids, self.pos, axis=1)
        self.nsp = rng.integers(0, 2, n)

    def __getitem__(self, i):
        return (self.ids[i], self.types[i], self.mask[i], self.pos[i],
                self.mlm[i], self.nsp[i])

    def __len__(self):
        return len(self.ids)


def feed_step(step, batch):
    """One TrainStep on a fed batch (ids, types, mask, positions, MLM
    labels, NSP labels); returns the loss, synchronised."""
    ids, types, mask, pos, mlm, nsp = batch
    return float(step(ids, types, mask, masked_positions=pos,
                      labels=(mlm, nsp))["loss"])


def make_loader(torch, ds, workers: int = RESUME_WORKERS):
    """The DataLoader of these phases: a seeded shuffle (numpy's
    default_rng, so the JAX package's order), batches of RESUME_BATCH,
    ``workers`` worker processes, a bounded wait."""
    from paddle_tpu_torch.data import BatchSampler, DataLoader, RandomSampler
    return DataLoader(ds, batch_sampler=BatchSampler(
        RandomSampler(ds, seed=SEED), batch_size=RESUME_BATCH,
        drop_last=True), num_workers=workers, timeout=120.0)


def resume_model(torch, layers: int, dtype):
    """BERT at full width (dropout 0.1) from SEED on the card, cast to
    ``dtype`` as the JAX bench casts (parameters only)."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    model = BertForPretraining(BertConfig(num_hidden_layers=layers),
                               device="cuda", seed=SEED)
    if dtype != "float32":
        model = cast_model_to_low_precision(model, dtype)
    return model


def state_on_host(step) -> dict:
    """Synchronised host copies of every leaf of ``step.state_dict()``."""
    from paddle_tpu_torch import io
    return {k: v.detach().to("cpu", copy=True)
            for k, v in io.flatten(step.state_dict()).items()}


def equal_states(torch, a: dict, b: dict) -> list:
    """The leaves in which two host states differ bit for bit (or that
    one of them lacks)."""
    def bits(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or a[k].shape != b[k].shape
                  or not torch.equal(bits(a[k]), bits(b[k])))


def path_launches(name: str, counts: dict, per_step: dict, steps: int):
    """Raises unless ``counts`` are ``steps`` times ``per_step``."""
    want = {k: steps * n for k, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != {want} "
                             f"({steps} steps of {per_step})")


def run_feed(torch, step, batches, steps: int) -> dict:
    """``steps`` TrainSteps on ``batches`` (an iterable of device
    batches): the first (eager, then the capture) alone, the rest under
    torch.profiler: their wall, device time and busy share."""
    from torch.profiler import ProfilerActivity, profile
    it = iter(batches)
    losses = [feed_step(step, next(it))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = [step(*b[:3], masked_positions=b[3], labels=b[4:])["loss"]
                for _, b in zip(range(steps - 1), it)]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    losses += [float(o) for o in outs]
    rows = device_rows(prof, steps - 1)
    step_ms = wall_ms / (steps - 1)
    device_ms = sum(r[0] for r in rows) if rows else None
    return {"losses": losses, "step_ms": step_ms,
            "tokens_per_s": RESUME_BATCH * RESUME_SEQ / step_ms * 1e3,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / step_ms if rows else None}


def timed_step(torch, step, batch) -> tuple:
    """``(loss, stream ms)``: feed_step between two events on the current
    stream (the step's device time plus any wait for its host calls)."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    loss = feed_step(step, batch)
    marks[1].record()
    marks[1].synchronize()
    return loss, marks[0].elapsed_time(marks[1])


def check_data_feed(torch) -> tuple:
    """BERT-base in bf16 with the fused flags over the flat fused state
    (the main path), captured, fed for RESUME_STEPS steps from
    ``DataLoader(num_workers=RESUME_WORKERS)`` through ``DeviceLoader``
    (staged in its pinned arena), against the same step on the same
    batches made on the card beforehand, from the same weights:
    the same losses bit for bit, the loader's wait per batch, step ms
    and busy share side by side. Returns (report, launch counts of the
    fed run)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.data import DeviceLoader
    model = resume_model(torch, 12, "bfloat16")
    cfg = model.config
    ds = PretrainSamples(RESUME_STEPS * RESUME_BATCH, RESUME_SEQ,
                         cfg.vocab_size, SEED + 40)
    start = host_copy(dict(model.named_parameters()))
    restore = flag_scope(FUSED_FLAGS)
    try:
        premade = [tuple(t.to("cuda") for t in b)
                   for b in make_loader(torch, ds, workers=0)]
        torch.cuda.synchronize()
        step = make_train_step(model, fused_state=True, compiled=True)
        ref = run_feed(torch, step, premade, RESUME_STEPS)
        del step, premade
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        step = make_train_step(model, fused_state=True, compiled=True)
        feed = DeviceLoader(make_loader(torch, ds), buffer_size=2)
        kernels.reset_launch_counts()
        fed = run_feed(torch, step, feed, RESUME_STEPS)
        counts = kernels.launch_counts()
    finally:
        restore()
    per_step = expected_launches(RESUME_SEQ, cfg.num_hidden_layers,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 FUSED_FLAGS,
                                 rows=RESUME_BATCH * RESUME_MASKED,
                                 vocab=cfg.vocab_size)
    path_launches("data_feed", counts, per_step, RESUME_STEPS)
    res = {"batch": RESUME_BATCH, "seq": RESUME_SEQ,
           "masked_per_row": RESUME_MASKED, "workers": RESUME_WORKERS,
           "steps": RESUME_STEPS, "premade": ref, "fed": fed,
           "loader_wait_ms": feed.wait_ms,
           "loader_wait_ms_median_after_first": float(np.median(
               feed.wait_ms[1:])),
           "arena": dict(feed.arena.stats),
           "same_losses": fed["losses"] == ref["losses"],
           "captures": step.captures}
    log(f"data feed: {json.dumps(res)}")
    if not res["same_losses"] or not all(np.isfinite(fed["losses"])):
        raise AssertionError(f"data feed: the fed run's losses "
                             f"{fed['losses']} != {ref['losses']}")
    del step, feed, model
    torch.cuda.empty_cache()
    return res, counts


def check_resume(torch, name: str, layers: int, dtype: str, flags: dict,
                 fused_state: bool) -> tuple:
    """Run A: RESUME_STEPS captured steps fed by the worker DataLoader
    through a pinned DeviceLoader. Run B, from the same weights, seed
    and loader: RESUME_AT steps, then ``AsyncCheckpointer.save`` of
    ``step.state_dict()`` with host_state {global_step, epoch,
    batch_in_epoch}, then step RESUME_AT + 1 at once while the writer
    works; a fresh loader's ``iter_from(RESUME_AT)`` forks its workers
    while the writer may still run; once it is written, the checkpoint is
    restored in place into run B's live captured step, whose graph
    replays step RESUME_AT + 1 on the same batch: no new capture, the
    loss of that step bit for bit and every leaf equal to run A's after
    that step (a restore that missed an address the graph reads, the
    generator's registered state included, shows there); then the
    model, step, optimizer,
    loader and checkpointer are dropped, built afresh, ``restore_latest``
    and ``set_state_dict`` restore, and the run goes on to RESUME_STEPS.
    Losses RESUME_AT+1..RESUME_STEPS and every leaf of the state
    (parameters, fp32 masters, moments, step counter, generator) must
    equal run A's bit for bit, and the saved checkpoint the state at step
    RESUME_AT (a torn save shows there). Every step's stream time is
    taken beside its wall time, and the fetch of the step during the
    write apart. Two saves at the end time the
    fresh checkpointer's first save (pinning its host memory) and a later
    one (reusing it). Returns (report, launch counts of both runs)."""
    from paddle_tpu_torch import io, kernels
    from paddle_tpu_torch.data import DeviceLoader
    ckpt_dir = os.path.join(CKPT_DIR, name)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    restore = flag_scope(flags)
    try:
        model = resume_model(torch, layers, dtype)
        cfg = model.config
        ds = PretrainSamples(RESUME_STEPS * RESUME_BATCH, RESUME_SEQ,
                             cfg.vocab_size, SEED + 50)
        kernels.reset_launch_counts()
        # run A, uninterrupted
        step = make_train_step(model, fused_state=fused_state,
                               compiled=True)
        losses_a, ms_a, stream_ms_a = [], [], []
        for batch in DeviceLoader(make_loader(torch, ds)):
            t0 = time.perf_counter()
            loss, ms = timed_step(torch, step, batch)
            losses_a.append(loss)
            ms_a.append((time.perf_counter() - t0) * 1e3)
            stream_ms_a.append(ms)
            if len(losses_a) == RESUME_AT + 1:
                after_a = state_on_host(step)
        end_a = state_on_host(step)
        del step, model
        # run B: stopped at RESUME_AT, saved while it goes on, resumed
        model = resume_model(torch, layers, dtype)
        step = make_train_step(model, fused_state=fused_state,
                               compiled=True)
        feed = iter(DeviceLoader(make_loader(torch, ds)))
        losses_b = [feed_step(step, next(feed)) for _ in range(RESUME_AT)]
        at_save = state_on_host(step)
        ck = io.AsyncCheckpointer(ckpt_dir, max_to_keep=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step.state_dict(), step=RESUME_AT,
                host_state={"global_step": RESUME_AT, "epoch": 0,
                            "batch_in_epoch": RESUME_AT})
        save_ms = (time.perf_counter() - t0) * 1e3
        # whether the enqueued copies had run by then, and the device time
        # of the next step (events on the stream around it)
        after_save = torch.cuda.Event()
        after_save.record()
        copies_done = after_save.query()
        writing_at_next_step = ck._thread.is_alive()
        t0 = time.perf_counter()
        batch = next(feed)
        fetch_ms = (time.perf_counter() - t0) * 1e3
        loss_next, next_stream_ms = timed_step(torch, step, batch)
        next_step_ms = (time.perf_counter() - t0) * 1e3
        # a new epoch's workers fork while the writer may still run
        fresh = iter(DeviceLoader(make_loader(torch, ds).iter_from(
            RESUME_AT)))
        first = next(fresh)
        writing_at_fork = ck._thread is not None and ck._thread.is_alive()
        t0 = time.perf_counter()
        ck.wait()
        wait_s = time.perf_counter() - t0
        writer_s = ck.last_write_s
        path = os.path.join(ckpt_dir, f"ckpt-{RESUME_AT}")
        saved = io.load(path)
        # restored in place under the live graph, step RESUME_AT + 1 again
        captures_before = step.captures
        step.set_state_dict(saved)
        loss_again = feed_step(step, batch)
        inplace_differ = equal_states(torch, state_on_host(step), after_a)
        inplace = {"captures_before": captures_before,
                   "captures_after": step.captures, "loss": loss_again,
                   "state_leaves_differing": inplace_differ}
        del feed, step, model, ck, batch, after_a
        torch.cuda.empty_cache()
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(path) for f in fs)
        t0 = time.perf_counter()
        problems = io.verify(path)
        verify_s = time.perf_counter() - t0
        torn = equal_states(torch, saved, at_save)
        del at_save, saved
        # the fresh process
        model = resume_model(torch, layers, dtype)
        step = make_train_step(model, fused_state=fused_state,
                               compiled=True)
        ck = io.AsyncCheckpointer(ckpt_dir)
        t0 = time.perf_counter()
        flat, at = ck.restore_latest()
        step.set_state_dict(flat)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del flat
        host_state = ck.host_state()
        losses_r = [feed_step(step, first)]
        losses_r += [feed_step(step, b) for b in fresh]
        counts = kernels.launch_counts()
        end_b = state_on_host(step)
        captures = step.captures
        # the fresh checkpointer's first save pins its host memory; saved
        # again, it reuses it
        save_ms_at_end, writer_s_at_end = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(step.state_dict(), step=RESUME_STEPS,
                    host_state={"global_step": RESUME_STEPS, "epoch": 0,
                                "batch_in_epoch": RESUME_STEPS})
            save_ms_at_end.append((time.perf_counter() - t0) * 1e3)
            ck.wait()
            writer_s_at_end.append(ck.last_write_s)
        kept = ck.intact_steps()
        del step, model, fresh
    finally:
        restore()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    differ = equal_states(torch, end_a, end_b)
    steady_a = float(np.median(ms_a[1:]))
    res = {"layers": layers, "dtype": dtype, "flags": flags,
           "fused_state": fused_state, "batch": RESUME_BATCH,
           "seq": RESUME_SEQ, "steps": RESUME_STEPS, "saved_at": RESUME_AT,
           "losses_uninterrupted": losses_a,
           "losses_before_save": losses_b, "loss_during_write": loss_next,
           "losses_resumed": losses_r,
           "resumed_equal": losses_r == losses_a[RESUME_AT:]
           and losses_b == losses_a[:RESUME_AT]
           and loss_next == losses_a[RESUME_AT],
           "state_leaves": len(end_a), "state_leaves_differing": differ,
           "checkpoint_equals_saved_state": not torn,
           "checkpoint_leaves_differing": torn,
           "verify_problems": problems, "restored_step": at,
           "host_state": host_state, "checkpoint_bytes": ckpt_bytes,
           "save_host_blocking_ms": save_ms, "writer_s": writer_s,
           "wait_for_writer_s": wait_s,
           "writer_busy_at_next_step": writing_at_next_step,
           "writer_busy_at_worker_fork": writing_at_fork,
           "step_ms_during_write": next_step_ms,
           "copies_done_when_save_returned": copies_done,
           "batch_fetch_ms_during_write": fetch_ms,
           "step_stream_ms_during_write": next_stream_ms,
           "step_ms_uninterrupted_median": steady_a,
           "step_ms_uninterrupted_at_same_step": ms_a[RESUME_AT],
           "step_stream_ms_uninterrupted": stream_ms_a,
           "verify_s": verify_s, "restore_s": restore_s,
           "captures_after_restore": captures,
           "inplace_restore_under_graph": inplace,
           "inplace_restore_equal": loss_again == loss_next
           and captures_before == inplace["captures_after"]
           and not inplace_differ,
           "end_saves_host_blocking_ms": save_ms_at_end,
           "end_saves_writer_s": writer_s_at_end, "checkpoints_kept": kept}
    log(f"resume ({name}): {json.dumps(res)}")
    if not res["resumed_equal"] or not res["inplace_restore_equal"] \
            or differ or torn or problems \
            or at != RESUME_AT or host_state["batch_in_epoch"] != RESUME_AT \
            or kept != [RESUME_AT, RESUME_STEPS]:
        raise AssertionError(f"resume ({name}): {res}")
    per_step = expected_launches(RESUME_SEQ, layers,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 flags, rows=RESUME_BATCH * RESUME_MASKED,
                                 vocab=cfg.vocab_size)
    # run A's steps, run B's before and during the write and its replay
    # after the restore in place, the resumed ones
    path_launches(name, counts, per_step, 2 * RESUME_STEPS + 2)
    return res, counts


def eval_launches(layers: int) -> dict:
    """Kernel launches of one eval forward: attention below
    flash_attention_min_seq takes the plain path, so LayerNorm is the
    forward's kernel (2 a layer, the embeddings', the MLM transform's)."""
    out = {k: 0 for k in expected_launches(RESUME_SEQ, layers, 64)}
    out["layer_norm"] = 2 * layers + 2
    return out


def check_eval_captured(torch) -> tuple:
    """BERT-base in bf16 (the JAX bench's cast), eval forward at RESUME_BATCH
    x RESUME_SEQ through the captured ``EvalStep`` against the eager one,
    on EVAL_CALLS batches: outputs and metrics bit for bit, both timed
    (median host wall of a synchronised call); a metric that synchronises
    with the host must raise naming itself. Returns (report, launch
    counts of the captured calls)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.static import EvalStep
    model = resume_model(torch, 12, "bfloat16")
    cfg = model.config
    ds = PretrainSamples(EVAL_CALLS * RESUME_BATCH, RESUME_SEQ,
                         cfg.vocab_size, SEED + 60)
    batches = [tuple(t.to("cuda") for t in b)
               for b in make_loader(torch, ds, workers=0)]
    metrics = {"nsp_acc": lambda out, nsp: (out[1].argmax(-1) == nsp)
               .float().mean(),
               "mlm_logit_max": lambda out, nsp: out[0].float().amax()}
    eager = EvalStep(model, metrics, compiled=False)
    captured = EvalStep(model, metrics)

    def run(es):
        outs, ms = [], []
        for ids, types, mask, pos, _, nsp in batches:
            t0 = time.perf_counter()
            out, met = es(None, None, ids, types, mask, pos, labels=(nsp,))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append((out, met))
        return outs, ms

    want, eager_ms = run(eager)
    kernels.reset_launch_counts()
    got, cap_ms = run(captured)
    counts = kernels.launch_counts()
    same = all(all(torch.equal(a, b) for a, b in zip(g[0], w[0]))
               and all(torch.equal(g[1][k], w[1][k]) for k in metrics)
               for g, w in zip(got, want))
    try:
        EvalStep(model, {"host_metric": lambda out, nsp: float(
            out[1].sum())})(None, None, *batches[0][:4],
                            labels=(batches[0][5],))
        named = False
    except RuntimeError as e:
        named = "host_metric" in str(e)
    res = {"batch": RESUME_BATCH, "seq": RESUME_SEQ, "calls": EVAL_CALLS,
           "bitwise": same, "captures": captured.captures,
           "capture_ms": captured.capture_ms,
           "eager_ms": eager_ms, "captured_ms": cap_ms,
           "eager_ms_median_after_first": float(np.median(eager_ms[1:])),
           "captured_ms_median_after_first": float(np.median(cap_ms[1:])),
           "nsp_acc": [float(g[1]["nsp_acc"]) for g in got],
           "host_sync_metric_raises_named": named,
           "out_dtype": str(got[0][0][0].dtype)}
    log(f"eval captured: {json.dumps(res)}")
    want_counts = {k: EVAL_CALLS * n for k, n in eval_launches(
        cfg.num_hidden_layers).items()}
    if not same or captured.captures != 1 or not named \
            or counts != want_counts:
        raise AssertionError(f"eval captured: {res}, launches {counts} "
                             f"(want {want_counts})")
    del eager, captured, model, batches, got, want
    torch.cuda.empty_cache()
    return res, counts


def run_resume_phases(torch) -> tuple:
    """Phase 5c. Returns (report, launch counts of each path)."""
    report, counts = {}, {}
    report["data_feed"], counts["data_feed"] = check_data_feed(torch)
    for name, run in RESUME_RUNS.items():
        report[name], counts[name] = check_resume(torch, name, **run)
    report["eval_captured"], counts["eval_captured"] = \
        check_eval_captured(torch)
    return report, counts


# ---------------------------------------------------------------------------
# phase 6: serving through the engine
# ---------------------------------------------------------------------------

def build_model(torch, config: dict, device: str):
    """GPT at ``config`` width with GPT-2's N(0, 0.02) weights from SEED
    (zero biases, unit LayerNorm scale)."""
    from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel
    model = GPTLanguageModel(GPTConfig(**config), device=device, seed=SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def make_prompts(n: int, lo: int, hi: int, vocab: int):
    rng = np.random.default_rng(SEED + 1)
    lengths = np.linspace(lo, hi, n).astype(int)
    rng.shuffle(lengths)
    return [rng.integers(0, vocab, size=int(k)).tolist() for k in lengths]


def serve(torch, engine, prompts, max_new: int, late: int = 0,
          late_after_steps: int = 3, temperature: float = 0.0):
    """Add all but the last ``late`` prompts, step ``late_after_steps``
    times, add the rest (they join mid-decode) and step to quiescence.
    Request i samples with seed SEED + i. Returns (tokens per prompt,
    stats)."""
    sync = torch.cuda.synchronize if engine.device.type == "cuda" \
        else (lambda: None)
    out, added, first = {}, {}, {}
    order = []
    step_ms, decode_step_ms = [], []

    def add(p):
        sid = engine.add_request(p, max_new_tokens=max_new,
                                 temperature=temperature,
                                 seed=SEED + len(order))
        added[sid] = time.perf_counter()
        order.append(sid)

    sync()
    t0 = time.perf_counter()
    for p in prompts[:len(prompts) - late]:
        add(p)
    steps = 0
    while engine.active() or len(order) < len(prompts):
        if steps == late_after_steps:
            for p in prompts[len(prompts) - late:]:
                add(p)
        decode_only = not engine.scheduler.waiting and all(
            s.prefill_done for s in engine.scheduler.running)
        ts = time.perf_counter()
        events = engine.step()
        sync()
        now = time.perf_counter()
        step_ms.append((now - ts) * 1e3)
        if decode_only and engine.scheduler.running:
            decode_step_ms.append((now - ts) * 1e3)
        steps += 1
        if steps > 10_000:
            raise AssertionError("engine did not quiesce")
        for ev in events:
            if ev["type"] == "error":
                raise AssertionError(f"engine error event: {ev}")
            if ev["type"] == "token":
                out.setdefault(ev["seq_id"], []).append(ev["token"])
                first.setdefault(ev["seq_id"], now)
    wall = time.perf_counter() - t0
    tokens = [out.get(sid, []) for sid in order]
    ttft = [(first[sid] - added[sid]) * 1e3 for sid in order]
    stats = {"requests": len(prompts), "steps": steps,
             "tokens": sum(len(t) for t in tokens), "wall_s": wall,
             "tokens_per_s": sum(len(t) for t in tokens) / wall,
             "ttft_ms_p50": float(np.median(ttft)),
             "step_ms_p50": float(np.median(step_ms)),
             "decode_step_ms_p50": float(np.median(decode_step_ms))
             if decode_step_ms else None}
    return tokens, stats


def top2_gap(torch, model, ids, temperature: float = 0.0,
             key=None) -> float:
    """Top-two gap, in logit units, of what the sampler ranks for the
    token after ``ids`` on the dense forward: the logits at temperature
    0, else logits / T plus the noise of position ``key``, times T."""
    from paddle_tpu_torch.serving_llm.engine import sampling_noise
    with torch.no_grad():
        scores = model(torch.tensor([ids], device=model.device))[0, -1]
    scores = scores.float()
    if temperature > 0.0:
        scores = (scores / temperature + sampling_noise(
            [key], scores.shape[-1], model.device)[0]) * temperature
    top = torch.topk(scores, 2).values
    return float(top[0] - top[1])


def hold_against(torch, model, prompts, got, want, what: str,
                 temperature: float = 0.0):
    """Token-for-token parity with a near-tie escape: at the first
    mismatch the top-two scores the sampler ranks on the dense forward
    must differ by < NEAR_TIE logits (the rest of that sequence then
    follows another context and is not compared). Request i sampled
    with seed SEED + i, as ``serve`` sets. Returns the accepted
    near-ties."""
    ties = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{what}: request {i} has {len(g)} "
                                 f"tokens, reference {len(w)}")
        mism = [j for j in range(len(w)) if g[j] != w[j]]
        if not mism:
            continue
        j = mism[0]
        gap = top2_gap(torch, model, p + w[:j], temperature, (SEED + i, j))
        if gap >= NEAR_TIE:
            raise AssertionError(
                f"{what}: request {i} diverges at token {j} "
                f"({g[j]} vs {w[j]}) where the dense top-two gap is "
                f"{gap} >= {NEAR_TIE}")
        ties.append({"request": i, "token": j, "gap": gap})
        log(f"{what}: near-tie accepted at request {i} token {j} "
            f"(gap {gap})")
    return ties


def dense_reference(torch, model, prompts, max_new: int):
    return [model.generate(torch.tensor([p], device=model.device),
                           max_new_tokens=max_new)[0].tolist()
            for p in prompts]


def run_serving(torch, config: dict, device: str, n_req: int, lo: int,
                hi: int, max_new: int, pool_blocks: int, n_spec: int):
    """Phases 4-5 (any device, so it can be rehearsed on the CPU at a
    small config). Returns (report, launch counts of each engine run,
    what ``run_wire`` serves again: the model, the prompts, the plain
    run's tokens and stats)."""
    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch.serving_llm import LLMEngine
    model = build_model(torch, config, device)
    prompts = make_prompts(n_req, lo, hi, config["vocab_size"])
    counts = {}

    def run(name, prompts, k=0, **serve_kw):
        """One engine run with every launch count set to 0 just before
        it and read just after; the pool must drain clean."""
        set_flags({"speculative_k": k})
        try:
            eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                            max_decode_batch=16,
                            draft_model=model if k else None,
                            device=device)
            kernels.reset_launch_counts()
            tokens, stats = serve(torch, eng, prompts, max_new, **serve_kw)
            counts[name] = kernels.launch_counts()
        finally:
            set_flags({"speculative_k": 0})
        if eng.allocator.num_used != 0:
            raise AssertionError(f"{name}: {eng.allocator.num_used} KV "
                                 f"blocks leaked")
        eng.allocator.check()
        for tk in tokens:
            if len(tk) != max_new or not all(0 <= x < config["vocab_size"]
                                             for x in tk):
                raise AssertionError(f"{name}: output has the wrong shape")
        if k:
            stats.update(proposed=eng.spec_proposed_total,
                         accepted=eng.spec_accepted_total,
                         accept_rate=eng.spec_accepted_total
                         / max(1, eng.spec_proposed_total))
        log(f"{name}: {json.dumps(stats)}")
        return tokens, stats

    few = prompts[:n_spec]
    tokens, stats = run("serving", prompts, late=n_req // 2)
    spec_tokens, spec_stats = run("speculative", few, k=SPEC_K)
    # sampling at temperature > 0, plain and speculative, same seeds
    hot_tokens, hot_stats = run("sampled", few, temperature=TEMPERATURE)
    hot_spec_tokens, hot_spec_stats = run("sampled_speculative", few,
                                          k=SPEC_K, temperature=TEMPERATURE)

    dense = dense_reference(torch, model, prompts, max_new)
    ties = hold_against(torch, model, prompts, tokens, dense,
                        "engine vs dense generate")
    spec_ties = hold_against(torch, model, few, spec_tokens,
                             tokens[:n_spec], "speculative vs plain")
    spec_ties += hold_against(torch, model, few, hot_spec_tokens,
                              hot_tokens, "sampled speculative vs plain",
                              temperature=TEMPERATURE)
    for st in (spec_stats, hot_spec_stats):
        if st["proposed"] == 0 or (st["accept_rate"] != 1.0
                                   and not spec_ties):
            raise AssertionError(f"self-draft accept rate "
                                 f"{st['accept_rate']} != 1.0")
    with torch.no_grad():
        logits = model(torch.tensor([prompts[0][:8]], device=device))
    if tuple(logits.shape) != (1, 8, config["vocab_size"]) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("dense logits not finite or misshapen")
    report = {"serving": stats, "speculative": spec_stats,
              "sampled": hot_stats, "sampled_speculative": hot_spec_stats,
              "near_ties": ties + spec_ties}
    if device == "cuda":
        report["decode_profile"] = profile_decode(torch, model, prompts,
                                                  pool_blocks)
        prof = report["decode_profile"]
        log(f"decode profile: {json.dumps(prof)}")
        log(f"decode step: paged_attention "
            f"{prof['paged_attention_ms_per_step']} device ms and "
            f"layer_norm {prof['layer_norm_ms_per_step']} "
            f"({prof['layer_norm_launches_per_step']} launches) of "
            f"{prof['device_ms_per_step']}")
    served = {"model": model, "prompts": prompts, "tokens": tokens,
              "stats": stats}
    return report, counts, served


def profile_decode(torch, model, prompts, pool_blocks: int,
                   steps: int = 8) -> dict:
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of a full batch (all prompts prefilled first), device
    time by kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving_llm import LLMEngine
    eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                    max_decode_batch=16, device=model.device)
    for p in prompts:
        eng.add_request(p, max_new_tokens=steps + 4)
    while eng.scheduler.waiting or not all(
            s.prefill_done for s in eng.scheduler.running):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_rows(prof, steps)
    while eng.active():
        eng.step()
    device_ms = sum(r[0] for r in rows)
    out = {"steps": steps, "batch": len(prompts),
           "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms if rows else None,
           "device_busy_share": device_ms / wall_ms if rows else None}
    # the port's kernels in the step (warm L2, unlike the kernel timer)
    for name in ("paged_attention", "layer_norm"):
        mine = [r for r in rows if name in r[2]]
        out[f"{name}_ms_per_step"] = sum(r[0] for r in mine) \
            if rows else None
        out[f"{name}_launches_per_step"] = sum(r[1] for r in mine) \
            if rows else None
    out["top_ms_per_step_launches_name"] = rows[:12]
    return out


# ---------------------------------------------------------------------------
# phase 6b: GPT-2-small served over the wire: clients -> Router -> two
# inference.Server backends -> LLMStreamBridge -> LLMEngine -> kernels
# ---------------------------------------------------------------------------

# the wire runs: the 16 greedy requests from 4 client threads; the router's
# added latency (4 requests direct to a backend, then through the router);
# 4 speculative streams; then 4 sampled streams placed on one backend by
# prefix affinity (a shared 64-token prefix), whose backend is stopped once
# each has WIRE_FAILOVER_AFTER tokens
WIRE = dict(clients=4, latency_probes=4, failover_streams=4,
            failover_prefix=64, failover_tail=32, failover_max_new=64,
            probe_interval_s=0.5)
WIRE_FAILOVER_AFTER = 4


class ForwardCounter:
    """Counts the engines' model forwards by kind while a wire run is
    served, from the engine method that made each: a prefill chunk, a
    decode step (12 paged launches at 12 layers), a verify forward (12
    verify launches, or 12 paged ones when every window is one token),
    a draft proposal (the self-draft is the model itself). Every forward
    runs 2 LayerNorms a layer and the final one. Installed as an
    instance attribute over ``model.forward_with_attn``; the serving
    threads call it concurrently."""

    def __init__(self, model):
        import threading
        self.model = model
        self.layers = len(model.blocks)
        self._inner = model.forward_with_attn
        self._lock = threading.Lock()
        self.reset()
        model.forward_with_attn = self._forward

    def _forward(self, ids, positions, attn_fn):
        kind = sys._getframe(1).f_code.co_name
        if kind == "_decode_speculative" and ids.shape[1] == 1:
            kind = "_decode"  # a verify of one-token windows: single-query
        t0 = time.perf_counter()
        out = self._inner(ids, positions, attn_fn)
        dt = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.host_ms[kind] = self.host_ms.get(kind, 0.0) + dt
        return out

    def reset(self) -> None:
        with self._lock:
            self.calls, self.host_ms = {}, {}

    def host_ms_mean(self) -> dict:
        """Mean host ms a forward of each kind (the forward's enqueue:
        the device runs behind it), GIL waits included."""
        return {k: self.host_ms[k] / n for k, n in self.calls.items()}

    def expected_launches(self) -> dict:
        c = self.calls
        return {"layer_norm": (2 * self.layers + 1) * sum(c.values()),
                "paged_attention": self.layers * c.get("_decode", 0),
                "paged_attention_multiquery":
                    self.layers * c.get("_decode_speculative", 0)}

    def restore(self) -> None:
        del self.model.forward_with_attn


class WireStreams:
    """Streams through one port ``Client`` each, timed on the client:
    TTFT from the first read (the frame goes out there) to the first
    chunk, and every gap between two chunks. A negative terminal frame
    raises in ``Client.generate_stream``; it is kept and fails the run."""

    def __init__(self):
        import threading
        self.tokens, self.ttft_ms, self.gaps_ms = {}, [], []
        self.errors = []
        self._lock = threading.Lock()

    def run(self, port: int, i: int, prompt, **kw) -> None:
        from paddle_tpu_torch.inference import Client
        toks, gaps = [], []
        try:
            with Client(port=port, timeout_s=120.0,
                        deadline_s=120.0) as cli:
                t_prev = t0 = time.perf_counter()
                for ch in cli.generate_stream(prompt, **kw):
                    now = time.perf_counter()
                    if not toks:
                        ttft = (now - t0) * 1e3
                    else:
                        gaps.append((now - t_prev) * 1e3)
                    t_prev = now
                    toks.extend(int(x) for x in ch.reshape(-1))
        except Exception as e:  # noqa: BLE001 — recorded, fails the run
            with self._lock:
                self.errors.append(f"stream {i}: {type(e).__name__}: {e}")
            return
        with self._lock:
            self.tokens[i] = toks
            self.ttft_ms.append(ttft)
            self.gaps_ms.extend(gaps)

    def check(self, what: str, n: int, max_new: int) -> list:
        if self.errors:
            raise AssertionError(f"{what}: {self.errors}")
        short = [i for i in range(n) if len(self.tokens.get(i, ())) != max_new]
        if short:
            raise AssertionError(f"{what}: streams {short} are short")
        return [self.tokens[i] for i in range(n)]

    def stats(self, wall_s: Optional[float] = None) -> dict:
        n_tok = sum(len(t) for t in self.tokens.values())
        out = {"streams": len(self.tokens), "tokens": n_tok,
               "ttft_ms_p50": float(np.median(self.ttft_ms)),
               "inter_chunk_ms_p50": float(np.median(self.gaps_ms))}
        if wall_s is not None:
            out.update(wall_s=wall_s, tokens_per_s=n_tok / wall_s)
        return out


def serve_threads(streams: WireStreams, port: int, prompts, clients: int,
                  **kw) -> float:
    """``prompts`` through ``clients`` threads (thread k takes prompts
    k, k + clients, ...), request i sampled with seed SEED + i. Returns
    the wall seconds."""
    import threading

    def worker(k):
        for i in range(k, len(prompts), clients):
            streams.run(port, i, prompts[i], seed=SEED + i, **kw)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a wire client thread did not finish")
    return time.perf_counter() - t0


def wire_counted(torch, name: str, counter, engines, fn, counts: dict):
    """Run ``fn`` with every launch count and the forward counts set to 0
    just before it and read just after; on the card each kernel of the
    run's path must have launched, exactly as often as the engines'
    forwards imply. The pools must drain clean."""
    from paddle_tpu_torch import kernels
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counter.reset()
    kernels.reset_launch_counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts[name] = kernels.launch_counts()
    want = counter.expected_launches()
    REPORT.setdefault("wire_forwards", {})[name] = {
        "calls": dict(counter.calls),
        "host_ms_mean": counter.host_ms_mean()}
    for eng in engines:
        if eng.allocator.num_used != 0:
            raise AssertionError(f"{name}: {eng.allocator.num_used} KV "
                                 f"blocks leaked")
        eng.allocator.check()
    if engines[0].device.type == "cuda":
        for k in PATH_KERNELS[name]:
            if counts[name][k] <= 0:
                raise AssertionError(f"{name}: {k} never launched")
        for k, n in want.items():
            if counts[name][k] != n:
                raise AssertionError(
                    f"{name}: {counts[name][k]} {k} launches, the engines' "
                    f"forwards {dict(counter.calls)} imply {n}")
    log(f"{name}: launches {json.dumps({k: counts[name][k] for k in want})}"
        f" from forwards {json.dumps(counter.calls)}, host ms a forward "
        f"{json.dumps(counter.host_ms_mean())}")
    return out


def failover_prompts(vocab: int, n: int, prefix: int, tail: int):
    """``n`` prompts sharing one ``prefix``-token start (whole KV blocks,
    so prefix affinity places them together), each with its own tail."""
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, vocab, size=prefix).tolist()
    return [shared + rng.integers(0, vocab, size=tail).tolist()
            for _ in range(n)]


def stop_holder(router, servers, n: int) -> int:
    """Stop the one backend holding all ``n`` open streams. Returns its
    index."""
    snap = router.snapshot()
    busy = [b for b in snap["backends"] if b["streams_active"] > 0]
    if len(busy) != 1 or busy[0]["streams_active"] != n:
        raise AssertionError(f"failover: the {n} streams are not on one "
                             f"backend: {snap}")
    port = int(busy[0]["name"].rsplit(":", 1)[1])
    idx = next(k for k, s in enumerate(servers) if s.port == port)
    servers[idx].stop()
    return idx


def run_wire(torch, served: dict, max_new: int, pool_blocks: int,
             n_spec: int, clients: int, latency_probes: int,
             failover_streams: int, failover_prefix: int,
             failover_tail: int, failover_max_new: int,
             probe_interval_s: float):
    """Phase 6b (any device, so it can be rehearsed on the CPU). Returns
    (report, launch counts of each wire run)."""
    import socket
    import threading
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import Client, Server
    from paddle_tpu_torch.serving_llm import LLMEngine, Router
    model, prompts = served["model"], served["prompts"]
    device = model.device
    vocab = model.config.vocab_size
    threads_before = set(threading.enumerate())
    counts, report = {}, {}

    # the uninterrupted in-process runs the failover streams are held to
    fo_prompts = failover_prompts(vocab, failover_streams, failover_prefix,
                                  failover_tail)
    ref_eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                        max_decode_batch=16, device=device)
    fo_ref, _ = serve(torch, ref_eng, fo_prompts, failover_max_new,
                      temperature=TEMPERATURE)
    del ref_eng

    counter = ForwardCounter(model)
    engines = [LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                         max_decode_batch=16, draft_model=model,
                         device=device) for _ in range(2)]
    servers = [Server(None, llm_engine=e) for e in engines]
    router = Router([("127.0.0.1", s.port) for s in servers],
                    probe_interval_s=probe_interval_s).start()
    ports = [router.port] + [s.port for s in servers]
    try:
        # greedy: the 16 requests from `clients` threads, held against
        # the in-process engine's tokens
        wire = WireStreams()
        wall = wire_counted(
            torch, "wire", counter, engines,
            lambda: serve_threads(wire, router.port, prompts, clients,
                                  max_new_tokens=max_new), counts)
        tokens = wire.check("wire", len(prompts), max_new)
        report["wire"] = wire.stats(wall)
        report["wire_near_ties"] = hold_against(
            torch, model, prompts, tokens, served["tokens"],
            "wire vs in-process engine")

        # the router's added latency: the same requests one at a time,
        # straight to a backend and then through the router
        lat = {}
        for via, port in (("direct", servers[0].port),
                          ("router", router.port)):
            probe = WireStreams()
            for i in range(latency_probes):
                probe.run(port, i, prompts[i], max_new_tokens=max_new)
            hold_against(torch, model, prompts[:latency_probes],
                         probe.check(via, latency_probes, max_new),
                         served["tokens"][:latency_probes], f"{via} probe")
            lat[via] = probe.stats()
        report["router_added_ms"] = {
            "ttft_p50": lat["router"]["ttft_ms_p50"]
            - lat["direct"]["ttft_ms_p50"],
            "inter_chunk_p50": lat["router"]["inter_chunk_ms_p50"]
            - lat["direct"]["inter_chunk_ms_p50"],
            "direct": lat["direct"], "router": lat["router"]}

        # speculative (self-draft, k = SPEC_K) through the router, held
        # as the in-process speculative run: against the plain tokens,
        # every draft token accepted
        few = prompts[:n_spec]
        before = [(e.spec_proposed_total, e.spec_accepted_total)
                  for e in engines]
        set_flags({"speculative_k": SPEC_K})
        try:
            spec = WireStreams()
            wall = wire_counted(
                torch, "wire_speculative", counter, engines,
                lambda: serve_threads(spec, router.port, few, clients,
                                      max_new_tokens=max_new), counts)
        finally:
            set_flags({"speculative_k": 0})
        spec_ties = hold_against(torch, model, few,
                                 spec.check("wire speculative", n_spec,
                                            max_new),
                                 served["tokens"][:n_spec],
                                 "wire speculative vs plain")
        proposed = sum(e.spec_proposed_total - b[0]
                       for e, b in zip(engines, before))
        accepted = sum(e.spec_accepted_total - b[1]
                       for e, b in zip(engines, before))
        if proposed == 0 or (accepted != proposed and not spec_ties):
            raise AssertionError(f"wire speculative: accepted {accepted} "
                                 f"of {proposed} self-draft tokens")
        report["wire_speculative"] = dict(spec.stats(wall),
                                          proposed=proposed,
                                          accepted=accepted)

        # failover at temperature 0.8: the streams placed on one backend,
        # which is stopped mid-generation; the router resumes each on the
        # other with the sample offset
        set_flags({"router_prefix_affinity": True})
        fo_before = router.snapshot()["failovers_total"]

        def failover():
            clis = [Client(port=router.port, timeout_s=120.0,
                           deadline_s=120.0) for _ in fo_prompts]
            try:
                gens, toks = [], []
                for i, (cli, p) in enumerate(zip(clis, fo_prompts)):
                    # one at a time, so each finds the first's placement
                    g = cli.generate_stream(
                        p, max_new_tokens=failover_max_new,
                        temperature=TEMPERATURE, seed=SEED + i)
                    toks.append([int(next(g)[0])])
                    gens.append(g)
                for tk, g in zip(toks, gens):
                    while len(tk) < WIRE_FAILOVER_AFTER:
                        tk.append(int(next(g)[0]))
                victim = stop_holder(router, servers, len(gens))
                for tk, g in zip(toks, gens):
                    tk.extend(int(c[0]) for c in g)
                return victim, toks
            finally:
                for cli in clis:
                    cli.close()

        try:
            victim, fo_tokens = wire_counted(torch, "wire_failover", counter,
                                             engines, failover, counts)
        finally:
            set_flags({"router_prefix_affinity": False})
        for i, tk in enumerate(fo_tokens):
            if len(tk) != failover_max_new:
                raise AssertionError(f"failover stream {i} has {len(tk)} "
                                     f"tokens")
        failovers = router.snapshot()["failovers_total"] - fo_before
        if failovers != failover_streams:
            raise AssertionError(f"failover: {failovers} failovers for "
                                 f"{failover_streams} streams")
        report["wire_failover"] = {
            "streams": failover_streams, "stopped_backend": victim,
            "failovers": failovers, "after_tokens": WIRE_FAILOVER_AFTER,
            "near_ties": hold_against(torch, model, fo_prompts, fo_tokens,
                                      fo_ref, "failover vs uninterrupted",
                                      temperature=TEMPERATURE)}
        report["router"] = router.snapshot()
    finally:
        router.stop()
        for s in servers:
            s.stop()
        counter.restore()
    # nothing left behind: every port closed, every thread ended
    for port in ports:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
        except ConnectionRefusedError:
            continue
        raise AssertionError(f"wire: port {port} is still bound")
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        if not left:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"wire: threads left running: {left}")
        time.sleep(0.05)
    inproc = served["stats"]
    report["in_process"] = {k: inproc[k] for k in (
        "tokens_per_s", "ttft_ms_p50", "step_ms_p50", "decode_step_ms_p50")}
    w = report["wire"]
    log(f"wire: {w['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{w['ttft_ms_p50']:.2f} ms, inter-chunk p50 "
        f"{w['inter_chunk_ms_p50']:.3f} ms; in process: "
        f"{inproc['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{inproc['ttft_ms_p50']:.2f} ms, decode step p50 "
        f"{inproc['decode_step_ms_p50']:.3f} ms; router adds "
        f"{report['router_added_ms']['ttft_p50']:.3f} ms TTFT p50, "
        f"{report['router_added_ms']['inter_chunk_p50']:.3f} ms "
        f"inter-chunk p50")
    log(f"wire report: {json.dumps(report)}")
    return report, counts


# ---------------------------------------------------------------------------
# phase 7: observability and chaos on the card: metrics on, serving faults
# in process and over the wire, value faults in the captured train step,
# spans under torch.profiler
# ---------------------------------------------------------------------------

# phase 7's training: BERT at full width and 2 layers, bf16 with the fused
# flags over the flat fused state (as BF16_RUNS' fused run), b8 x s512
OBS_TRAIN = dict(layers=2, batch=8, seq=512, steps=5)
# the serving chaos: the Kth llm_decode hit (per sequence per step) fails
# its sequence; the Kth token write over the wire fails its stream, which
# the router resumes on the other backend once its deadline passes
OBS_DECODE_AT = 10
OBS_CHUNK_WRITE_AT = 20
OBS_ROUTER_DEADLINE_S = 3.0


def metric_total(obs, name: str, field: str = "value", **labels) -> float:
    """A series of the port's registry: a counter's or gauge's value, or
    a histogram's ``count`` / ``sum`` (0 when absent)."""
    m = obs.registry().get(name)
    if m is None:
        return 0.0
    if m.kind == "histogram":
        return float(getattr(m, field)(**labels))
    v = m.value(**labels)
    return 0.0 if v is None else float(v)


def obs_serving(torch, served: dict, base_counts: dict, max_new: int,
                pool_blocks: int) -> tuple:
    """Phase 7a: phase 6's 16-request serving run again with metrics on.
    Every counter that counts what the run counts another way must equal
    it, the paged launches 12 per decode forward the counters record, the
    launches those of the run with metrics off; gauges agree, every
    sequence's timeline is queued -> admitted -> prefill_chunk -> token x
    max_new -> finished, one step record per engine step. Returns (report,
    launch counts)."""
    from paddle_tpu_torch import kernels, observability as obs, set_flags
    from paddle_tpu_torch.serving_llm import LLMEngine
    model, prompts = served["model"], served["prompts"]
    layers = len(model.blocks)
    obs.reset_all()
    set_flags({"enable_metrics": True, "llm_step_ring": 4096})
    try:
        eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                        max_decode_batch=16, device=model.device)
        kernels.reset_launch_counts()
        tokens, stats = serve(torch, eng, prompts, max_new,
                              late=len(prompts) // 2)
        counts = kernels.launch_counts()
        agree = eng.allocator.gauges_agree()
        decode_fwd = metric_total(obs, "llm_decode_batch_size", "count")
        prefills = metric_total(obs, "llm_prefill_chunk_ms", "count")
        records = obs.stepprof.ring().recent()
        timelines = obs.seqtrace.ring().recent()
        res = {
            "stats": stats, "gauges_agree": agree,
            "decode_forwards": decode_fwd, "prefill_chunks": prefills,
            "decode_batch_sum": metric_total(obs, "llm_decode_batch_size",
                                             "sum"),
            "admitted": metric_total(obs, "llm_tenant_admitted_total",
                                     tenant="default"),
            "kv_blocks_alloc_total": metric_total(obs,
                                                  "kv_blocks_alloc_total"),
            "kv_blocks_freed_total": metric_total(obs,
                                                  "kv_blocks_freed_total"),
            "kv_blocks_used": metric_total(obs, "kv_blocks_used"),
            "step_records": len(records),
            "step_record_tokens": sum(r["tokens"] for r in records),
            "timelines": len(timelines)}
    finally:
        set_flags({"enable_metrics": False, "llm_step_ring": 256})
    want_tl = ["queued", "admitted", "prefill_chunk"] + ["token"] * max_new \
        + ["finished"]
    bad_tl = [tl["seq_id"] for tl in timelines
              if [e["ev"] for e in tl["events"]] != want_tl]
    n_tok = sum(len(t) for t in tokens)
    checks = {
        "tokens_equal_off": tokens == served["tokens"],
        "launches_equal_off": counts == base_counts,
        "paged_is_12_per_decode_forward":
            counts["paged_attention"] == layers * decode_fwd,
        "ln_is_25_per_forward":
            counts["layer_norm"] == (2 * layers + 1)
            * (decode_fwd + prefills),
        "prefills": prefills == len(prompts),
        "decode_batch_sum": res["decode_batch_sum"]
        == n_tok - len(prompts),
        "admitted": res["admitted"] == len(prompts),
        "kv_alloc": res["kv_blocks_alloc_total"] == eng.allocator.allocs_total,
        "kv_freed": res["kv_blocks_freed_total"] == eng.allocator.freed_total
        == eng.allocator.allocs_total,
        "kv_used_zero": res["kv_blocks_used"] == 0,
        "gauges_agree": agree is True,
        "step_records": res["step_records"] == stats["steps"],
        "step_record_tokens": res["step_record_tokens"] == n_tok,
        "timelines": res["timelines"] == len(prompts) and not bad_tl}
    res["checks"] = checks
    # the host clock spreads between runs: phase 6's run (off) and this
    # one (on), then one more of each, in turns
    turns = {"off": [served["stats"]], "on": [stats]}
    for metrics in (False, True):
        set_flags({"enable_metrics": metrics})
        try:
            again = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                              max_decode_batch=16, device=model.device)
            turns["on" if metrics else "off"].append(
                serve(torch, again, prompts, max_new,
                      late=len(prompts) // 2)[1])
        finally:
            set_flags({"enable_metrics": False})
            obs.reset_all()
    res["metrics_off_vs_on"] = {
        mode: {k: [st[k] for st in runs]
               for k in ("tokens_per_s", "decode_step_ms_p50")}
        for mode, runs in turns.items()}
    log(f"obs serving: {json.dumps(res)}")
    log(f"obs serving, metrics off against on (off, on, off, on): "
        f"{json.dumps(res['metrics_off_vs_on'])}")
    if not all(checks.values()):
        failed = [k for k, v in checks.items() if not v]
        raise AssertionError(f"obs serving: failed {failed}: {res}, "
                             f"launches {counts} (off: {base_counts}), "
                             f"timelines off {bad_tl[:4]}")
    return res, counts


def chaos_serving(torch, served: dict, max_new: int, pool_blocks: int,
                  n: int) -> tuple:
    """Phase 7b, in process: ``llm_decode:at=OBS_DECODE_AT`` over ``n``
    requests: exactly one sequence ends with an error event, its blocks
    freed (``check()``), every other sequence's tokens those of the
    fault-free run, the fault counted once and flight-recorded. Returns
    (report, launch counts)."""
    from paddle_tpu_torch import kernels, observability as obs, set_flags
    from paddle_tpu_torch.serving_llm import LLMEngine
    model, prompts = served["model"], served["prompts"][:n]
    obs.reset_all()
    set_flags({"enable_metrics": True,
               "fault_spec": f"llm_decode:at={OBS_DECODE_AT}"})
    try:
        eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                        max_decode_batch=16, device=model.device)
        sids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
        kernels.reset_launch_counts()
        toks, errors = {}, []
        while eng.active():
            for ev in eng.step():
                if ev["type"] == "token":
                    toks.setdefault(ev["seq_id"], []).append(ev["token"])
                elif ev["type"] == "error":
                    errors.append(ev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        set_flags({"enable_metrics": False, "fault_spec": ""})
    eng.allocator.check()
    injected = metric_total(obs, "faults_injected_total", point="llm_decode")
    kinds = [e["kind"] for e in obs.flight_recorder().events()]
    res = {"requests": n, "errors": [e["seq_id"] for e in errors],
           "error_message": errors[0]["error"] if errors else None,
           "faults_injected": injected,
           "flight": sorted(set(kinds)),
           "kv_blocks_used": eng.allocator.num_used}
    failed = errors[0]["seq_id"] if len(errors) == 1 else None
    others = [i for i, sid in enumerate(sids) if sid != failed]
    res["near_ties"] = hold_against(
        torch, model, [prompts[i] for i in others],
        [toks[sids[i]] for i in others],
        [served["tokens"][i] for i in others], "decode chaos vs fault-free")
    log(f"obs chaos serving: {json.dumps(res)}")
    if len(errors) != 1 or injected != 1 or eng.allocator.num_used != 0 \
            or "fault_injected" not in kinds or "seq_timeline" not in kinds \
            or len(toks.get(failed, [])) >= max_new:
        raise AssertionError(f"obs chaos serving: {res}")
    return res, counts


def chaos_wire(torch, served: dict, max_new: int, pool_blocks: int,
               n: int, probe_interval_s: float) -> tuple:
    """Phase 7b over the wire: ``n`` greedy streams from ``n`` clients
    through a router over two backends with
    ``llm_chunk_write:at=OBS_CHUNK_WRITE_AT``: the one failed write
    cancels its sequence (blocks freed, one forced flight record, counted
    once), the router resumes that stream on the other
    backend after its deadline, and every stream's tokens equal the
    fault-free run's. Launches as the engines' forwards imply. Returns
    (report, launch counts)."""
    import threading
    from paddle_tpu_torch import observability as obs, set_flags
    from paddle_tpu_torch.inference import Server
    from paddle_tpu_torch.serving_llm import LLMEngine, Router
    model, prompts = served["model"], served["prompts"][:n]
    threads_before = set(threading.enumerate())
    counts = {}
    obs.reset_all()
    counter = ForwardCounter(model)
    engines = [LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                         max_decode_batch=16, device=model.device)
               for _ in range(2)]
    servers = [Server(None, llm_engine=e) for e in engines]
    set_flags({"enable_metrics": True,
               "router_backend_deadline_s": OBS_ROUTER_DEADLINE_S})
    router = Router([("127.0.0.1", s.port) for s in servers],
                    probe_interval_s=probe_interval_s).start()
    try:
        set_flags({"fault_spec": f"llm_chunk_write:at={OBS_CHUNK_WRITE_AT}"})
        streams = WireStreams()
        wall = wire_counted(
            torch, "obs_wire_chaos", counter, engines,
            lambda: serve_threads(streams, router.port, prompts, n,
                                  max_new_tokens=max_new), counts)
        tokens = streams.check("wire chaos", n, max_new)
        snap = router.snapshot()
    finally:
        set_flags({"enable_metrics": False, "fault_spec": "",
                   "router_backend_deadline_s": 30.0})
        router.stop()
        for s in servers:
            s.stop()
        counter.restore()
    outcomes = [tl["outcome"] for tl in obs.seqtrace.ring().recent()]
    kinds = [e["kind"] for e in obs.flight_recorder().events()]
    res = dict(streams.stats(wall),
               faults_injected=metric_total(obs, "faults_injected_total",
                                            point="llm_chunk_write"),
               cancelled_total=metric_total(
                   obs, "serving_stream_cancelled_total"),
               failovers=snap["failovers_total"],
               router_failovers_total=metric_total(
                   obs, "router_failovers_total"),
               timeline_outcomes=sorted(outcomes),
               flight=sorted(set(kinds)))
    res["near_ties"] = hold_against(torch, model, prompts, tokens,
                                    served["tokens"][:n],
                                    "wire chaos vs fault-free")
    log(f"obs chaos wire: {json.dumps(res)}")
    deadline = time.monotonic() + 10.0
    while [t for t in threading.enumerate()
           if t not in threads_before and t.is_alive()]:
        if time.monotonic() > deadline:
            raise AssertionError("wire chaos: threads left running")
        time.sleep(0.05)
    # two engines of one process number their sequences alike, so a
    # timeline can be retired as "superseded" by the other engine's
    # sequence of the same id: the bridge's counter and flight record
    # are the exact count of cancelled streams
    if res["faults_injected"] != 1 or res["cancelled_total"] != 1 \
            or kinds.count("serving_stream_cancelled") != 1 \
            or outcomes.count("cancelled") > 1 or res["failovers"] != 1 \
            or "fault_injected" not in kinds:
        raise AssertionError(f"obs chaos wire: {res}")
    return res, counts


def chaos_train_run(torch, spec: str, compiled: bool, listener=None):
    """OBS_TRAIN's steps of a fresh bf16 fused BERT from SEED with ``spec``
    armed and metrics on, the host step count published before each step;
    ``listener`` on the anomaly sentinel meanwhile. Returns (step, host
    states after each step, losses, launch counts, step ms)."""
    from paddle_tpu_torch import kernels, observability as obs
    from paddle_tpu_torch.testing import faults
    model = resume_model(torch, OBS_TRAIN["layers"], "bfloat16")
    data = bert_batch(torch, model.config, OBS_TRAIN["batch"],
                      OBS_TRAIN["seq"], "cuda", SEED + 7)
    step = make_train_step(model, fused_state=True, compiled=compiled)
    restore = flag_scope(dict(FUSED_FLAGS, enable_metrics=True,
                              fault_spec=spec,
                              flash_attention_min_seq_train=512))
    sent = obs.anomaly_sentinel()
    if listener is not None:
        sent.add_listener(listener)
    states, losses, step_ms = [], [], []
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for k in range(1, OBS_TRAIN["steps"] + 1):
            faults.set_step_context(k)
            t0 = time.perf_counter()
            losses.append(float(step(data[0], labels=data[1:])["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(state_on_host(step))
        counts = kernels.launch_counts()
        step.sync_to_model()  # the blocking flush of the probes
    finally:
        faults.set_step_context(None)
        if listener is not None:
            sent.remove_listener(listener)
        restore()
    return step, states, losses, counts, step_ms


def chaos_training(torch) -> tuple:
    """Phase 7c: ``nonfinite_grad:step=3`` over OBS_TRAIN's steps,
    captured: one capture, step 3 leaves every parameter, master, moment
    and the step counter as step 2 left them, ``nonfinite_steps_total``
    1 after the flush, the run equal to its eager twin bit for bit; then
    ``loss_spike:step=4``, whose fourth loss the sentinel flags as a
    spike (its warm-up fed by the runs before). Returns (report, launch
    counts of the captured and the eager drill)."""
    from paddle_tpu_torch import observability as obs
    obs.reset_all()
    spec = "nonfinite_grad:step=3"
    cap, cstates, closs, ccounts, cms = chaos_train_run(torch, spec, True)
    nonfinite = metric_total(obs, "nonfinite_steps_total")
    captures = cap.captures
    del cap
    eager, estates, eloss, ecounts, ems = chaos_train_run(torch, spec,
                                                          False)
    del eager
    moved = equal_states(torch, cstates[1], cstates[2])
    moved = [k for k in moved if k != "generator"]
    twin = [equal_states(torch, a, b) for a, b in zip(cstates, estates)]
    seen = []
    spike, sstates, sloss, scounts, _ = chaos_train_run(
        torch, "loss_spike:step=4", True,
        listener=lambda series, v, kind: series == "loss"
        and seen.append(kind))
    spike_captures = spike.captures
    del spike, sstates
    per_step = expected_launches(
        OBS_TRAIN["seq"], OBS_TRAIN["layers"], 64, FUSED_FLAGS,
        rows=OBS_TRAIN["batch"] * OBS_TRAIN["seq"], vocab=30522)
    want = {k: OBS_TRAIN["steps"] * n for k, n in per_step.items()}
    res = {"spec": spec, "captures": captures, "losses": closs,
           "eager_losses": eloss, "step3_changed": moved,
           "nonfinite_steps_total": nonfinite,
           "twin_differs": [d for d in twin if d],
           "spike_losses": sloss, "spike_kinds": seen,
           "spike_captures": spike_captures,
           "step_ms_captured": cms, "step_ms_eager": ems}
    log(f"obs chaos training: {json.dumps(res)}")
    torch.cuda.empty_cache()
    if captures != 1 or moved or nonfinite != 1 or closs != eloss \
            or any(twin) or spike_captures != 1 \
            or seen != [None, None, None, "spike", None] \
            or ccounts != want or ecounts != want or scounts != want:
        raise AssertionError(f"obs chaos training: {res}, launches "
                             f"{ccounts} / {ecounts} / {scounts} (want "
                             f"{want})")
    return res, {"obs_train_chaos": ccounts,
                 "obs_train_chaos_eager": ecounts,
                 "obs_train_spike": scounts}


def train_metrics_off_on(torch, steps: int = 12) -> dict:
    """The captured bf16 fused step of OBS_TRAIN's model with metrics off
    and on, in turns (off, on, on, off), ``steps`` replays each: host ms a
    step (CUDA-synchronised), median over each run's replays."""
    from paddle_tpu_torch import observability as obs
    model = resume_model(torch, OBS_TRAIN["layers"], "bfloat16")
    data = bert_batch(torch, model.config, OBS_TRAIN["batch"],
                      OBS_TRAIN["seq"], "cuda", SEED + 7)
    out = {"off": [], "on": []}
    for metrics in (False, True, True, False):
        restore = flag_scope(dict(FUSED_FLAGS, enable_metrics=metrics,
                                  flash_attention_min_seq_train=512))
        try:
            step = make_train_step(model, fused_state=True, compiled=True)
            ms = []
            for _ in range(steps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(data[0], labels=data[1:])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            step.sync_to_model()
        finally:
            restore()
        out["on" if metrics else "off"].append(float(np.median(ms[1:])))
        del step
    obs.reset_all()
    res = {"steps": steps, "step_ms_off": out["off"],
           "step_ms_on": out["on"],
           "on_over_off": float(np.mean(out["on"]) / np.mean(out["off"]))}
    log(f"obs training, metrics off against on: {json.dumps(res)}")
    return res


def profiled_spans(torch, served: dict, pool_blocks: int) -> dict:
    """Phase 7d: under torch.profiler with metrics on, the engine's span
    (``LLMEngine.step``) around each decode step and ``TrainStep``'s
    around each replay (a ``cudaGraphLaunch`` inside it)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import observability as obs, set_flags
    from paddle_tpu_torch.serving_llm import LLMEngine
    model, prompts = served["model"], served["prompts"][:4]
    restore = flag_scope({"enable_metrics": True})
    try:
        eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                        max_decode_batch=16, device=model.device)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        eng.step()  # the prefills
        tmodel = resume_model(torch, OBS_TRAIN["layers"], "bfloat16")
        data = bert_batch(torch, tmodel.config, OBS_TRAIN["batch"],
                          OBS_TRAIN["seq"], "cuda", SEED + 7)
        set_flags(FUSED_FLAGS)
        step = make_train_step(tmodel, fused_state=True, compiled=True)
        step(data[0], labels=data[1:])  # the warm-up and the capture
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.step()
            for _ in range(2):
                step(data[0], labels=data[1:])
            torch.cuda.synchronize()
        while eng.active():
            eng.step()
        step.sync_to_model()
    finally:
        set_flags({k: False for k in FUSED_FLAGS})
        restore()
    # a span is a host range and, on the card's timeline, a device range
    # of the same name (the kernels it enqueued)
    events = prof.events()
    name = step._span_name

    def host_and_device(span):
        on_host = [e for e in events if e.name == span
                   and str(e.device_type).endswith("CPU")]
        on_card = [e for e in events if e.name == span
                   and not str(e.device_type).endswith("CPU")]
        return on_host, on_card

    eng_spans, eng_dev = host_and_device("LLMEngine.step")
    train_spans, train_dev = host_and_device(name)
    launches = [e for e in events if e.name == "cudaGraphLaunch"]
    inside = sum(1 for s in train_spans if any(
        s.time_range.start <= g.time_range.start <= s.time_range.end
        for g in launches))
    res = {"engine_spans": len(eng_spans), "train_spans": len(train_spans),
           "train_spans_around_a_replay": inside,
           "engine_span_host_ms": [e.time_range.elapsed_us() / 1e3
                                   for e in eng_spans],
           "engine_span_device_range_ms": [
               e.time_range.elapsed_us() / 1e3 for e in eng_dev],
           "train_span_host_ms": [e.time_range.elapsed_us() / 1e3
                                  for e in train_spans],
           "train_span_device_range_ms": [
               e.time_range.elapsed_us() / 1e3 for e in train_dev]}
    log(f"obs spans: {json.dumps(res)}")
    del step, tmodel
    obs.reset_all()
    torch.cuda.empty_cache()
    if len(eng_spans) != 3 or len(train_spans) != 2 or inside != 2:
        raise AssertionError(f"obs spans: {res}")
    return res


def run_observability(torch, served: dict, serve_counts: dict,
                      max_new: int, pool_blocks: int, n_spec: int) -> tuple:
    """Phase 7. Returns (report, launch counts of each path)."""
    counts = {}
    report = {}
    report["obs_serving"], counts["obs_serving"] = obs_serving(
        torch, served, serve_counts["serving"], max_new, pool_blocks)
    report["obs_serving_chaos"], counts["obs_serving_chaos"] = \
        chaos_serving(torch, served, max_new, pool_blocks, n_spec)
    report["obs_wire_chaos"], wire_counts = chaos_wire(
        torch, served, max_new, pool_blocks, n_spec,
        WIRE["probe_interval_s"])
    counts.update(wire_counts)
    report["obs_train_chaos"], train_counts = chaos_training(torch)
    counts.update(train_counts)
    report["obs_train_metrics_off_on"] = train_metrics_off_on(torch)
    report["obs_spans"] = profiled_spans(torch, served, pool_blocks)
    for name in ("obs_serving", "obs_serving_chaos", "obs_train_chaos",
                 "obs_train_chaos_eager", "obs_train_spike"):
        for k in PATH_KERNELS[name]:
            if counts[name][k] <= 0:
                raise AssertionError(f"{name}: {k} never launched")
    return report, counts


# ---------------------------------------------------------------------------
# phase 8: the live observability plane on the card: the HTTP exporter
# scraped while GPT-2-small is served over the wire and BERT-base trains
# captured, the goodput ledger and the program card, the hang doctor, fleet
# federation, and the plane's own cost
# ---------------------------------------------------------------------------

# the scraper's poll period and paths (8a, 8b), the serving bridge's
# period (long: 8a scrapes the transports itself, so that two backends'
# bridges cannot interleave their writes while they are compared)
PLANE_SCRAPE_S = 0.1
PLANE_SCRAPE_PATHS = ("/metrics", "/healthz", "/varz")
PLANE_BRIDGE_S = 600.0
# 8b: BERT-base bf16 with the fused flags over the flat fused state, b8 x
# s512, RESUME_MASKED masked positions a row, captured, fed by 2 worker
# processes; the checkpoint saved after PLANE_SAVE_AT steps
PLANE_TRAIN_STEPS = 10
PLANE_SAVE_AT = 5
# the ledger's buckets against the loop's own wall clock; the program
# card's FLOPs against the analytic count of the same products; the
# checkpoint bucket against the save's and wait's times on the loop's
# clock: between the ledger's stamp and the caller's the checkpoint
# writer may hold the interpreter lock for up to a switch interval each
# time, so the gap may reach two of them
PLANE_GOODPUT_RTOL = 0.005
PLANE_CKPT_SLACK_S = 2 * sys.getswitchinterval()
PLANE_FLOPS_RTOL = 0.01
# 8c: the injected step wedge (the Kth llm_decode hit sleeps), the hang
# monitor's period, the training heartbeat's timeout
PLANE_WEDGE_AT = 40
PLANE_WEDGE_MS = 3000
PLANE_HANG_CHECK_S = 0.05
PLANE_HEARTBEAT_TIMEOUT_S = 1.0
# 8e: steps per turn, and the stack sampler's rate while the plane is on
PLANE_COST_STEPS = 6
PLANE_SAMPLE_HZ = 100.0
PATH_KERNELS.update({
    "plane_serving": PATH_KERNELS["serving"],
    "plane_wire": PATH_KERNELS["wire"],
    "plane_wire_speculative": PATH_KERNELS["wire_speculative"],
    "plane_wire_failover": PATH_KERNELS["wire_failover"],
    "plane_train": PATH_KERNELS["train_seq512_bf16_fused"]})


def http_get(port: int, path: str, timeout: float = 30.0) -> tuple:
    """``(status, body)`` of a GET to the exporter on this machine."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_json(port: int, path: str, want: int = 200):
    code, body = http_get(port, path)
    if code != want:
        raise AssertionError(f"GET {path}: {code} (want {want}): "
                             f"{body[:500]}")
    return json.loads(body)


def prom_values(text: str) -> dict:
    """``{"name{labels}": value}`` of a Prometheus page's samples."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            key, _, v = ln.rpartition(" ")
            out[key] = float(v)
    return out


class Scraper:
    """A thread polling ``paths`` of the exporter every ``period_s`` while
    the code inside runs: every answer must be a 200 that parses (the
    Prometheus page line by line, the others as JSON). With
    ``serving_stalls`` a ``/healthz`` 503 is allowed where its body shows
    a serving engine the stall watchdog judges stalled (a step past
    ``llm_stall_factor`` x its EWMA and 0.5 s, which a busy host can
    cause over the wire): it is counted, and the engines' own
    ``stalls_total`` must then count the stall too."""

    LINE = re.compile(r"^[a-zA-Z_:][\w:.]*(\{.*\})? \S+$")

    def __init__(self, port: int, paths=PLANE_SCRAPE_PATHS,
                 period_s: float = PLANE_SCRAPE_S,
                 serving_stalls: bool = False):
        import threading
        self.port, self.paths, self.period_s = port, paths, period_s
        self.serving_stalls = serving_stalls
        self.stalled_503 = 0
        self.bad: list = []  # (path, code) of every other non-200
        self.codes = {p: [] for p in paths}
        self.ms = {p: [] for p in paths}
        self.errors: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chip-smoke-scraper")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise AssertionError("the scraper thread did not stop")

    def _run(self) -> None:
        while not self._stop.is_set():
            for p in self.paths:
                t0 = time.perf_counter()
                try:
                    code, body = http_get(self.port, p)
                    if p == "/metrics":
                        bad = [ln for ln in body.splitlines() if ln
                               and ln[0] != "#" and not self.LINE.match(ln)]
                        if bad:
                            raise ValueError(f"unparsable lines {bad[:3]}")
                    else:
                        page = json.loads(body)
                except Exception as e:  # noqa: BLE001 — fails the phase
                    self.errors.append(f"{p}: {type(e).__name__}: {e}")
                    continue
                self.codes[p].append(code)
                if code == 503 and p == "/healthz" and self.serving_stalls \
                        and any(e.get("stalled") for e in (page.get(
                            "serving") or {}).get("engines", [])):
                    self.stalled_503 += 1
                elif code != 200:
                    self.bad.append((p, code))
                self.ms[p].append((time.perf_counter() - t0) * 1e3)
            self._stop.wait(self.period_s)

    def report(self) -> dict:
        """The scrapes by path, their p50 ms, and ``ok``: every path
        answered, nothing failed, no unexplained non-200."""
        res = {"scrapes": {p: len(cs) for p, cs in self.codes.items()},
               "ms_p50": {p: float(np.median(v)) if v else None
                          for p, v in self.ms.items()},
               "healthz_503_serving_stalled": self.stalled_503,
               "errors": self.errors[:5], "non_200": self.bad[:10]}
        res["ok"] = not self.errors and not self.bad \
            and min(res["scrapes"].values()) > 0
        return res


def plane_serving(torch, served: dict, base_counts: dict, max_new: int,
                  pool_blocks: int, n_spec: int, clients: int,
                  failover_streams: int, failover_prefix: int,
                  failover_tail: int, failover_max_new: int,
                  probe_interval_s: float, **_) -> tuple:
    """Phase 8a: GPT-2-small served with ``enable_metrics`` on and
    ``metrics_port`` 0, the exporter brought up by ``inference.Server``,
    a scraper polling ``/metrics``, ``/healthz`` and ``/varz`` throughout:
    phase 6's in-process run (its tokens and launches), then over the
    wire (two backends behind a ``Router``) the 16 requests, the
    speculative streams and the sampled streams that fail over, each
    launching as its forwards imply; the pages must agree with what the
    run counts. Returns (report, launch counts of each run, the
    exporter's port)."""
    import threading
    from paddle_tpu_torch import kernels, observability as obs, set_flags
    from paddle_tpu_torch.inference import Server
    from paddle_tpu_torch.observability import server as obs_server
    from paddle_tpu_torch.observability import slo
    from paddle_tpu_torch.serving_llm import LLMEngine, Router
    model, prompts = served["model"], served["prompts"]
    device = model.device
    counts, res, checks = {}, {}, {}
    if obs_server.get() is not None:
        raise AssertionError("plane: an exporter is up before the phase")
    set_flags({"enable_metrics": True, "metrics_port": 0,
               "hang_check_interval_s": PLANE_HANG_CHECK_S})
    obs.reset_all()
    counter = ForwardCounter(model)
    engines = [LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                         max_decode_batch=16, draft_model=model,
                         device=device) for _ in range(2)]
    servers = [Server(None, llm_engine=e, stats_interval_s=PLANE_BRIDGE_S)
               for e in engines]
    exporter = obs_server.get()
    if exporter is None:
        raise AssertionError("plane: inference.Server brought up no "
                             "exporter")
    port = exporter.port
    router = Router([("127.0.0.1", s.port) for s in servers],
                    probe_interval_s=probe_interval_s).start()
    try:
        with Scraper(port, serving_stalls=True) as scraper:
            # phase 6's in-process run with the plane up: the same tokens
            # and the same launches as with it down
            eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                            max_decode_batch=16, device=device)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tokens, res["in_process"] = serve(torch, eng, prompts, max_new,
                                              late=len(prompts) // 2)
            torch.cuda.synchronize()
            counts["plane_serving"] = kernels.launch_counts()
            checks["in_process_tokens_equal_plane_down"] = \
                tokens == served["tokens"]
            checks["in_process_launches_equal_plane_down"] = \
                counts["plane_serving"] == base_counts["serving"]
            del eng

            # the 16 requests over the wire, a /trace window during decode
            obs.seqtrace.ring().reset()
            before = prom_values(http_get(port, "/metrics")[1])
            box = {}
            tracer = threading.Thread(
                target=lambda: box.update(trace=http_json(
                    port, "/trace?ms=500")), name="chip-smoke-trace")
            wire = WireStreams()

            def greedy():
                tracer.start()
                return serve_threads(wire, router.port, prompts, clients,
                                     max_new_tokens=max_new)

            wall = wire_counted(torch, "plane_wire", counter, engines,
                                greedy, counts)
            tracer.join(timeout=60)
            hold_against(torch, model, prompts,
                         wire.check("plane wire", len(prompts), max_new),
                         served["tokens"], "plane wire vs in-process")
            res["wire"] = wire.stats(wall)
            after = prom_values(http_get(port, "/metrics")[1])

            def delta(key):
                return after.get(key, 0.0) - before.get(key, 0.0)

            n_tok = len(prompts) * max_new
            calls = counter.calls
            res["wire_counters"] = {
                k: delta(k) for k in (
                    "serving_stream_requests_total",
                    "serving_stream_tokens_total",
                    'llm_tenant_admitted_total{tenant="default"}',
                    "llm_decode_batch_size_count",
                    "llm_decode_batch_size_sum",
                    "llm_prefill_chunk_ms_count")}
            wc = res["wire_counters"]
            checks["requests_counted"] = \
                wc["serving_stream_requests_total"] == len(prompts) \
                == wc['llm_tenant_admitted_total{tenant="default"}'] \
                == wc["llm_prefill_chunk_ms_count"]
            checks["tokens_counted"] = \
                wc["serving_stream_tokens_total"] == n_tok \
                and wc["llm_decode_batch_size_sum"] == n_tok - len(prompts)
            checks["decode_forwards_counted"] = \
                wc["llm_decode_batch_size_count"] == calls.get("_decode", 0)
            seqs = http_json(port, "/llm/seqs")
            tls = seqs["finished"] + seqs["live"]
            res["timelines"] = {
                "n": len(tls), "live": len(seqs["live"]),
                "trace_ids": len({t["trace_id"] for t in tls}),
                "outcomes": sorted({t["outcome"] for t in seqs["finished"]})}
            checks["timelines"] = not seqs["live"] \
                and res["timelines"]["trace_ids"] == len(prompts) \
                and set(res["timelines"]["outcomes"]) <= {"finished",
                                                          "superseded"}
            spans = [e for e in box.get("trace", {}).get("traceEvents", [])
                     if e.get("name") == "LLMEngine.step"]
            res["trace_window_engine_steps"] = len(spans)
            checks["trace_window_has_engine_steps"] = len(spans) > 0

            # speculative streams (the verify kernel), self-draft k = 3
            set_flags({"speculative_k": SPEC_K})
            try:
                spec = WireStreams()
                wire_counted(torch, "plane_wire_speculative", counter,
                             engines,
                             lambda: serve_threads(spec, router.port,
                                                   prompts[:n_spec], clients,
                                                   max_new_tokens=max_new),
                             counts)
            finally:
                set_flags({"speculative_k": 0})
            hold_against(torch, model, prompts[:n_spec],
                         spec.check("plane speculative", n_spec, max_new),
                         served["tokens"][:n_spec], "plane speculative")

            # the serving_* series of the bridge against each transport's
            # own STATS, read locally (both backends still up)
            bridged = []
            for s in servers:
                stats = s.scrape_stats()
                page = prom_values(http_get(port, "/metrics?name=serving_")[1])
                got = {k: page.get(f"serving_{k}") for k in (
                    "accepted_total", "replied_total", "connections_total",
                    "queue_cap", "queue_depth", "inflight")}
                bridged.append({"stats": {k: stats.get(k) for k in got},
                                "page": got})
            res["bridge"] = bridged
            checks["bridge_equals_native_stats"] = all(
                float(b["stats"][k]) == b["page"][k]
                for b in bridged for k in b["page"])

            # sampled streams placed on one backend, which is stopped
            set_flags({"router_prefix_affinity": True})
            try:
                fo_prompts = failover_prompts(model.config.vocab_size,
                                              failover_streams,
                                              failover_prefix, failover_tail)
                fo_before = router.snapshot()["failovers_total"]

                def failover():
                    from paddle_tpu_torch.inference import Client
                    clis = [Client(port=router.port, timeout_s=120.0,
                                   deadline_s=120.0) for _ in fo_prompts]
                    try:
                        gens = [c.generate_stream(
                            p, max_new_tokens=failover_max_new,
                            temperature=TEMPERATURE, seed=SEED + i)
                            for i, (c, p) in enumerate(zip(clis,
                                                           fo_prompts))]
                        toks = []
                        for g in gens:  # one at a time: affinity places
                            toks.append([int(next(g)[0])])
                        for tk, g in zip(toks, gens):
                            while len(tk) < WIRE_FAILOVER_AFTER:
                                tk.append(int(next(g)[0]))
                        stop_holder(router, servers, len(gens))
                        for tk, g in zip(toks, gens):
                            tk.extend(int(c[0]) for c in g)
                        return toks
                    finally:
                        for c in clis:
                            c.close()

                fo_tokens = wire_counted(torch, "plane_wire_failover",
                                         counter, engines, failover, counts)
            finally:
                set_flags({"router_prefix_affinity": False})
            failovers = router.snapshot()["failovers_total"] - fo_before
            checks["failover_streams_whole"] = failovers == failover_streams \
                and all(len(t) == failover_max_new for t in fo_tokens)
            routers = http_json(port, "/router")["routers"]
            res["router_page"] = routers
            checks["router_page"] = len(routers) == 1 \
                and len(routers[0]["backends"]) == 2 \
                and routers[0]["failovers_total"] >= failovers > 0

            alerts = http_json(port, "/alerts")
            pack = {s.name for s in slo.engine().specs()}
            res["alerts"] = {a["slo"]: a["state"] for a in alerts["alerts"]}
            checks["alerts_default_pack"] = len(pack) == 7 \
                and set(res["alerts"]) == pack \
                and all(s in slo.STATE_ORDER for s in res["alerts"].values())
            health = http_json(port, "/healthz")
            res["healthz"] = {k: health.get(k) for k in (
                "status", "devices", "device_count")}
            checks["healthz_names_the_card"] = health["ok"] and any(
                torch.cuda.get_device_name(0) in d
                for d in health["devices"])
        res["engine_stalls"] = sum(e.stalls_total for e in engines)
        checks["stalled_503s_are_counted_stalls"] = \
            scraper.stalled_503 == 0 or res["engine_stalls"] > 0
        res["scraper"] = scraper.report()
        checks["scrapes_all_answered"] = res["scraper"]["ok"]
        res["varz_versions"] = http_json(port, "/varz")["versions"]
    finally:
        router.stop()
        for s in servers:
            s.stop()
        counter.restore()
    res["checks"] = checks
    log(f"plane serving (8a): {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"plane serving: failed "
                             f"{[k for k, v in checks.items() if not v]}: "
                             f"{res}")
    return res, counts, port


def plane_hang(torch, served: dict, port: int, pool_blocks: int,
               n: int) -> dict:
    """Phase 8c, serving: ``llm_decode:at=PLANE_WEDGE_AT:sleep=...`` wedges
    one engine step for PLANE_WEDGE_MS (far past ``llm_stall_factor`` x
    its EWMA) on a named engine thread; while it hangs the hang monitor's
    ``hang_diagnosis`` must name ``_injected_wedge_sleep`` as the culprit
    frame, ``/stacks`` must list the engine thread in that frame and
    ``/healthz`` must answer 503; after it, 200 again."""
    import threading
    from paddle_tpu_torch import observability as obs, set_flags
    from paddle_tpu_torch.serving_llm import LLMEngine
    from paddle_tpu_torch.observability import stacks
    model, prompts = served["model"], served["prompts"][:n]
    eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                    max_decode_batch=16, device=model.device)
    box = {}
    # a new episode: 8a's busy host may have had a diagnosis debounced
    # within the doctor's window
    stacks.doctor().reset()

    def ours(e):
        return e["kind"] == "hang_diagnosis" and e["source"] == "serving" \
            and (e.get("culprit") or {}).get("thread") == "chip-smoke-engine"

    set_flags({"fault_spec":
               f"llm_decode:at={PLANE_WEDGE_AT}:sleep={PLANE_WEDGE_MS}"})
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: box.update(out=serve(
        torch, eng, prompts, SERVING["max_new"])), name="chip-smoke-engine")
    try:
        th.start()
        diag = stacks_page = health = None
        deadline = time.monotonic() + PLANE_WEDGE_MS / 1e3
        while time.monotonic() < deadline and diag is None:
            diag = next((e for e in obs.flight_recorder().events()
                         if ours(e)), None)
            time.sleep(0.02)
        if diag is not None:
            stacks_page = http_json(port, "/stacks")
            health = http_get(port, "/healthz")
        detected_s = time.perf_counter() - t0
        th.join(timeout=120)
    finally:
        set_flags({"fault_spec": ""})
    after = http_get(port, "/healthz")
    engine_rec = next((t for t in (stacks_page or {}).get("threads", [])
                       if t["name"] == "chip-smoke-engine"), None)
    culprit = (diag or {}).get("culprit") or {}
    res = {"diagnosis": diag and {k: diag.get(k) for k in (
        "source", "culprit", "detail")},
           "detected_after_s": detected_s,
           "stacks_engine_thread": engine_rec and {
               k: engine_rec.get(k) for k in ("state", "top", "frame")},
           "healthz_during": health and health[0],
           "healthz_after": after[0],
           "stalls": eng.stalls_total,
           "diagnoses": sum(1 for e in obs.flight_recorder().events()
                            if ours(e))}
    checks = {
        "engine_finished": not th.is_alive() and "out" in box
        and all(len(t) == SERVING["max_new"] for t in box["out"][0]),
        "diagnosis_names_the_wedge": str(culprit.get("frame", "")).endswith(
            ":_injected_wedge_sleep")
        and culprit.get("thread") == "chip-smoke-engine",
        "stacks_lists_the_engine": engine_rec is not None
        and str(engine_rec.get("top", "")).endswith(":_injected_wedge_sleep"),
        "healthz_503_while_wedged": res["healthz_during"] == 503,
        "healthz_200_after": res["healthz_after"] == 200,
        # the wedge's step, and any a busy host stalled besides
        "stall_counted": eng.stalls_total >= 1,
        "one_diagnosis_of_the_wedge": res["diagnoses"] == 1}
    res["checks"] = checks
    log(f"plane hang (8c, serving): {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"plane hang: failed "
                             f"{[k for k, v in checks.items() if not v]}: "
                             f"{res}")
    return res


def bert_step_flops(cfg, batch: int, seq: int, rows: int) -> dict:
    """The products of one fused BERT pretraining step as the card counts
    them: the dense matmuls (per layer the four projections and the two
    FFN products, the pooler and NSP classifier on the [CLS] rows, the MLM
    transform on the ``rows`` masked rows) x 3 for forward plus backward;
    the flash kernels' products over the full score matrix (forward 2,
    dq 3, dK/dV 4: the backward recomputes the scores); the fused xent's
    logits product once forward and 3 times backward (dlog, dW, dh).
    ``model`` is the algorithmic count (every product x 3, no
    recompute), the numerator of a model-FLOP rate."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, layers = batch * seq, cfg.num_hidden_layers
    dense = 3 * (layers * (4 * 2 * n * h * h + 2 * 2 * n * h * i)
                 + 2 * batch * h * h + 2 * batch * h * 2 + 2 * rows * h * h)
    scores = batch * cfg.num_attention_heads * seq * seq
    head_d = h // cfg.num_attention_heads
    flash = layers * (2 + 3 + 4) * 2 * scores * head_d
    xent = 4 * 2 * rows * v * h
    model = dense + 3 * layers * 2 * 2 * scores * head_d \
        + 3 * 2 * rows * v * h
    return {"dense": dense, "flash": flash, "xent": xent,
            "total": dense + flash + xent, "model": model}


def plane_training(torch, port: int) -> tuple:
    """Phase 8b, and 8c's heartbeat. BERT-base bf16 with the fused flags
    over the flat fused state, b8 x s512, captured, fed by
    ``DataLoader(num_workers=2)`` through ``DeviceLoader``, an
    ``AsyncCheckpointer`` save after PLANE_SAVE_AT steps, the goodput
    ledger driven as ``hapi.fit`` drives it, the scraper polling the
    exporter throughout (the capture included). Checks: the ledger's
    buckets sum to the loop's wall within PLANE_GOODPUT_RTOL,
    ``jit_compile_cold`` is the capture tracker's seconds, ``checkpoint``
    the save's and wait's measured host time, ``/goodput`` is
    ``ledger().snapshot()``, the program card's FLOPs the analytic count
    within PLANE_FLOPS_RTOL; the run equals its eager twin and a run
    with ``program_analytics`` off bit for bit (losses and every leaf of
    the state). Then ``/healthz`` turns 503 once the heartbeat is older
    than ``health_heartbeat_timeout_s`` and 200 after the next step.
    Returns (report, launch counts of the captured run)."""
    from paddle_tpu_torch import io, kernels, observability as obs
    from paddle_tpu_torch.data import DeviceLoader
    from paddle_tpu_torch.observability import goodput, server as obs_server
    model = resume_model(torch, 12, "bfloat16")
    cfg = model.config
    ds = PretrainSamples(PLANE_TRAIN_STEPS * RESUME_BATCH, RESUME_SEQ,
                         cfg.vocab_size, SEED + 80)
    start = host_copy(dict(model.named_parameters()))
    ckpt_dir = os.path.join(CKPT_DIR, "plane")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    restore = flag_scope(dict(FUSED_FLAGS, enable_metrics=True,
                              program_analytics=True))
    name = "TrainStep(BertForPretraining)"
    led = obs.goodput_ledger()
    hb = obs.gauge(obs_server.HEARTBEAT_GAUGE)
    res, checks = {}, {}
    try:
        premade = [tuple(t.to("cuda") for t in b)
                   for b in make_loader(torch, ds, workers=0)]
        torch.cuda.synchronize()
        # the main run
        step = make_train_step(model, fused_state=True, compiled=True)
        obs.program_cards().reset()
        led.reset()
        ck = io.AsyncCheckpointer(ckpt_dir, max_to_keep=1)
        feed = iter(DeviceLoader(make_loader(torch, ds), buffer_size=2))
        losses, step_ms, ckpt_s = [], [], 0.0
        tracked = sum(obs.recompile_tracker().get(name).stats()[
            "compile_times_s"]) if obs.recompile_tracker().get(name) else 0.0
        kernels.reset_launch_counts()
        with Scraper(port) as scraper:
            t_wall = time.perf_counter()
            led.start()
            for k in range(PLANE_TRAIN_STEPS):
                t0 = time.perf_counter()
                batch = next(feed)
                led.attribute("data_wait", time.perf_counter() - t0)
                compile_before = goodput.compile_seconds_total()
                cache_before = goodput.compile_cache_stats()
                t0 = time.perf_counter()
                losses.append(feed_step(step, batch))
                dt = time.perf_counter() - t0
                compile_dt = min(dt, max(0.0, goodput.compile_seconds_total()
                                         - compile_before))
                if compile_dt > 0:
                    led.attribute(goodput.classify_compile_bucket(
                        cache_before), compile_dt)
                led.attribute("step_compute", dt - compile_dt)
                step_ms.append(dt * 1e3)
                hb.set(time.time())
                if k + 1 == PLANE_SAVE_AT:
                    state = step.state_dict()
                    t0 = time.perf_counter()
                    ck.save(state, step=k + 1,
                            host_state={"global_step": k + 1})
                    ckpt_s += time.perf_counter() - t0
                    del state
            t0 = time.perf_counter()
            ck.wait()
            ckpt_s += time.perf_counter() - t0
            led.stop()
            wall = time.perf_counter() - t_wall
            counts = kernels.launch_counts()
        res["scraper"] = scraper.report()
        checks["scrapes_all_answered"] = res["scraper"]["ok"]
        snap = led.snapshot()
        page = http_json(port, "/goodput")
        rec = obs.recompile_tracker().get(name).stats()
        card = obs.program_cards().latest(name)
        end_main = state_on_host(step)
        # 8c: the training heartbeat goes stale, then the next step
        from paddle_tpu_torch import set_flags
        set_flags({"health_heartbeat_timeout_s": PLANE_HEARTBEAT_TIMEOUT_S})
        try:
            time.sleep(PLANE_HEARTBEAT_TIMEOUT_S * 1.5)
            stale = http_get(port, "/healthz")
            feed_step(step, premade[0])
            hb.set(time.time())
            fresh = http_get(port, "/healthz")
        finally:
            set_flags({"health_heartbeat_timeout_s": 300.0})
        heartbeat_diag = [e for e in obs.flight_recorder().events()
                          if e["kind"] == "hang_diagnosis"
                          and e["source"] == "train_heartbeat"]
        del step, feed, ck

        # the eager twin, then the captured run with analytics off, from
        # the same weights on the same batches
        twins = {}
        for twin, compiled, analytics in (("eager", False, True),
                                          ("analytics_off", True, False)):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
            set_flags({"program_analytics": analytics})
            step = make_train_step(model, fused_state=True,
                                   compiled=compiled)
            tl = [feed_step(step, b) for b in premade]
            twins[twin] = (tl, state_on_host(step))
            del step
        set_flags({"program_analytics": True})
    finally:
        restore()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    flops = bert_step_flops(cfg, RESUME_BATCH, RESUME_SEQ,
                            RESUME_BATCH * RESUME_MASKED)
    replay_ms = float(np.median(step_ms[1:]))
    buckets_sum = sum(snap["buckets"].values())
    tracker_s = sum(rec["compile_times_s"]) - tracked
    res.update({
        "steps": PLANE_TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
        "replay_ms_median": replay_ms, "loop_wall_s": wall,
        "ledger": snap, "tracker_capture_s": tracker_s,
        "checkpoint_host_s": ckpt_s,
        "card": {k: card.get(k) for k in (
            "signature", "flops", "cost_analysis", "memory_analysis",
            "peak_bytes_estimate", "counting_seconds", "harvest_seconds",
            "unavailable", "flops_by_op")} if card else None,
        "analytic_flops": flops,
        "achieved_tflops": card["flops"] / (replay_ms / 1e3) / 1e12
        if card else None,
        "achieved_model_tflops": flops["model"] / (replay_ms / 1e3) / 1e12,
        "captures": rec["traces"],
        "healthz_stale": stale[0], "healthz_after_step": fresh[0],
        "heartbeat_diagnoses": len(heartbeat_diag),
        "twin_losses": {k: v[0] for k, v in twins.items()}})
    checks.update({
        "buckets_sum_to_wall": abs(buckets_sum - wall)
        <= PLANE_GOODPUT_RTOL * wall,
        "compile_is_capture_seconds": tracker_s > 0 and abs(
            snap["buckets"]["jit_compile_cold"] - tracker_s)
        <= 1e-9 * max(1.0, tracker_s),
        "cache_hit_bucket_zero": snap["buckets"]["jit_compile_cache_hit"]
        == 0.0,
        "checkpoint_is_save_time": 0.0 < snap["buckets"]["checkpoint"]
        <= ckpt_s and ckpt_s - snap["buckets"]["checkpoint"]
        <= PLANE_CKPT_SLACK_S + PLANE_GOODPUT_RTOL * ckpt_s,
        "goodput_page_is_snapshot": page == json.loads(json.dumps(snap)),
        "card_flops_analytic": card is not None and abs(
            card["flops"] - flops["total"]) <= PLANE_FLOPS_RTOL
        * flops["total"],
        "finite_losses": all(np.isfinite(losses)),
        "captured_equals_eager": twins["eager"][0] == losses
        and not equal_states(torch, twins["eager"][1], end_main),
        "analytics_change_no_bit": twins["analytics_off"][0] == losses
        and not equal_states(torch, twins["analytics_off"][1], end_main),
        "one_capture": rec["traces"] == 1,
        "healthz_503_when_heartbeat_stale": stale[0] == 503
        and json.loads(stale[1]).get("wedged") is True,
        "healthz_200_after_next_step": fresh[0] == 200,
        "heartbeat_diagnosed": len(heartbeat_diag) == 1})
    res["checks"] = checks
    per_step = expected_launches(RESUME_SEQ, cfg.num_hidden_layers,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 FUSED_FLAGS,
                                 rows=RESUME_BATCH * RESUME_MASKED,
                                 vocab=cfg.vocab_size)
    log(f"plane training (8b): {json.dumps(res)}")
    log(f"plane training: card {res['card'] and res['card']['flops']:.6g} "
        f"FLOPs a step (analytic {flops['total']:.6g}), replay "
        f"{replay_ms:.3f} ms median: {res['achieved_tflops']:.2f} TFLOP/s "
        f"counted, {res['achieved_model_tflops']:.2f} TFLOP/s model")
    if not all(checks.values()):
        raise AssertionError(f"plane training: failed "
                             f"{[k for k, v in checks.items() if not v]}")
    path_launches("plane_train", counts, per_step, PLANE_TRAIN_STEPS)
    return res, counts


def plane_fleet(torch, port: int) -> dict:
    """Phase 8d: two ``FleetReporter``s (hosts chip-w0 and chip-w1) push
    this process's registry to the exporter's ``/fleet/push``: ``/fleet``
    must sum the counters and label the gauges ``{host=}``, and
    ``/fleet/health`` count both hosts fresh."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import fleet
    obs.counter("chip_smoke_fleet_probe_total", "8d probe").inc(3)
    obs.gauge("chip_smoke_fleet_probe_depth", "8d probe").set(2.5)
    hosts = ("chip-w0", "chip-w1")
    reps = [fleet.FleetReporter(f"127.0.0.1:{port}", host_id=h,
                                interval_s=60.0) for h in hosts]
    try:
        pushed = [r.push_once() for r in reps]
        page = prom_values(http_get(
            port, "/fleet?name=chip_smoke_fleet_")[1])
        health = http_json(port, "/fleet/health")
        gp = http_json(port, "/fleet/goodput")
    finally:
        for r in reps:
            r.stop()
    res = {"pushed": pushed, "page": page,
           "health_hosts": sorted(health["hosts"]),
           "goodput_hosts": sorted(gp["hosts"])}
    checks = {
        "pushed": all(pushed),
        "counters_summed": page.get("chip_smoke_fleet_probe_total") == 6.0,
        "gauges_host_labelled": all(
            page.get(f'chip_smoke_fleet_probe_depth{{host="{h}"}}') == 2.5
            for h in hosts),
        "hosts_fresh": set(hosts) <= set(health["hosts"])
        and not any(v["stale"] for v in health["hosts"].values()),
        "goodput_per_host": set(hosts) <= set(gp["hosts"]),
        "reporters_stopped": not any(r._thread.is_alive() for r in reps)}
    res["checks"] = checks
    log(f"plane fleet (8d): {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"plane fleet: failed "
                             f"{[k for k, v in checks.items() if not v]}: "
                             f"{res}")
    return res


def plane_cost(torch, served: dict, port: int, pool_blocks: int,
               max_new: int) -> dict:
    """Phase 8e: the plane off against on, in turns (off, on, off, on):
    on is ``enable_metrics``, the tsdb sampler, the stack sampler at
    PLANE_SAMPLE_HZ and the scraper polling every PLANE_SCRAPE_S; off is
    none of them (the idle exporter thread stays). Per turn: the
    captured BERT-base bf16 fused step's host ms (median of its steps
    after the first: a turn's first step may capture) and phase 6's
    decode-step p50 in process; per on-turn the stack sampler's own
    ``stack_sampler_overhead_ratio``."""
    import contextlib
    from paddle_tpu_torch import observability as obs, set_flags
    from paddle_tpu_torch.observability import stacks, tsdb
    from paddle_tpu_torch.serving_llm import LLMEngine
    model = resume_model(torch, 12, "bfloat16")
    cfg = model.config
    ds = PretrainSamples(PLANE_COST_STEPS * RESUME_BATCH, RESUME_SEQ,
                         cfg.vocab_size, SEED + 90)
    restore = flag_scope(dict(FUSED_FLAGS, enable_metrics=False,
                              stack_sample_hz=0.0))
    turns = []
    try:
        premade = [tuple(t.to("cuda") for t in b)
                   for b in make_loader(torch, ds, workers=0)]
        step = make_train_step(model, fused_state=True, compiled=True)
        for on in (False, True, False, True):
            stacks.sampler().reset()
            tsdb.stop()
            set_flags({"enable_metrics": on,
                       "stack_sample_hz": PLANE_SAMPLE_HZ if on else 0.0})
            if on:
                tsdb.start()
            scrape = Scraper(port) if on else contextlib.nullcontext()
            with scrape:
                ms = []
                for b in premade:
                    t0 = time.perf_counter()
                    feed_step(step, b)
                    ms.append((time.perf_counter() - t0) * 1e3)
                eng = LLMEngine(served["model"], block_size=16,
                                pool_blocks=pool_blocks, max_decode_batch=16,
                                device=served["model"].device)
                _, st = serve(torch, eng, served["prompts"], max_new,
                              late=len(served["prompts"]) // 2)
                del eng
                ratio = stacks.sampler().overhead_ratio() if on else None
            turns.append({"plane": "on" if on else "off",
                          "train_step_ms_median": float(np.median(ms[1:])),
                          "decode_step_ms_p50": st["decode_step_ms_p50"],
                          "tokens_per_s": st["tokens_per_s"],
                          "stack_sampler_overhead_ratio": ratio,
                          "stack_samples": stacks.sampler().status()[
                              "samples_total"]})
        del step
    finally:
        stacks.sampler().reset()
        tsdb.stop()
        restore()
    torch.cuda.empty_cache()
    res = {"turns": turns, "sample_hz": PLANE_SAMPLE_HZ,
           "scrape_period_s": PLANE_SCRAPE_S}
    log(f"plane cost (8e, off/on/off/on): {json.dumps(res)}")
    if not all(t["stack_samples"] > 0 for t in turns if t["plane"] == "on"):
        raise AssertionError(f"plane cost: the sampler never ticked: {res}")
    return res


def run_plane(torch, served: dict, serve_counts: dict, max_new: int,
              pool_blocks: int, n_spec: int) -> tuple:
    """Phase 8. Returns (report, launch counts of each path). The plane
    is torn down after it: exporter, reporters, samplers, monitor."""
    from paddle_tpu_torch import observability as obs, set_flags
    from paddle_tpu_torch.observability import fleet, server as obs_server
    report, counts = {}, {}
    try:
        report["plane_serving"], c, port = plane_serving(
            torch, served, serve_counts, max_new, pool_blocks, n_spec,
            **WIRE)
        counts.update(c)
        report["plane_hang_serving"] = plane_hang(torch, served, port,
                                                  pool_blocks, n_spec)
        report["plane_training"], counts["plane_train"] = plane_training(
            torch, port)
        report["plane_fleet"] = plane_fleet(torch, port)
        report["plane_cost"] = plane_cost(torch, served, port, pool_blocks,
                                          max_new)
    finally:
        fleet.stop_reporter()
        obs_server.stop()
        set_flags({"enable_metrics": False, "metrics_port": 0,
                   "hang_check_interval_s": 1.0})
        obs.reset_all()
    return report, counts


# ---------------------------------------------------------------------------
# phase 9: the inference export, the Predictor and tensor serving
# ---------------------------------------------------------------------------

# BERT-base served as tensors: exported with jit.save at [None, PRED_SEQ]
# (input_ids, token_type_ids, attention_mask), loaded with
# create_predictor(Config(dir)) and run at PRED_BATCHES (buckets 1, 4, 8,
# 32 and 64 of the default ladder); seq 512 at buckets 8 and 32; a bf16
# copy at bucket 8; the card against a CPU export at PRED_CPU_BATCH
PRED_SEQ = 128
PRED_BATCHES = (1, 3, 8, 17, 64)
PRED_SEQ512_BATCHES = (5, 20)
PRED_BF16_BATCH = 6
# the bf16 predictor's gap to the fp32 model, at most this many times
# the bf16 plain composition's (two draws of one rounding noise; a
# wrong cast or scale is O(1))
PRED_BF16_NOISE = 2.0
PRED_CPU_BATCH = 8
PRED_TIMING_ITERS = 10
# the predictor behind a Server: CLIENTS threads x REQUESTS requests of
# LO..HI rows each
PRED_WIRE = dict(clients=8, requests=8, lo=1, hi=4, max_batch=16,
                 wait_ms=2)
# the exported artifacts of phase 9 (removed after each run)
PRED_DIR = "chip_smoke_export"
# where phase 9 builds its models and expects the predictor's outputs (a
# CPU rehearsal sets "cpu")
PRED_DEVICE = "cuda"
PRED_INPUTS = ("input_ids", "token_type_ids", "attention_mask")
# LayerNorm launches of one BERT-base forward: the embeddings' and two in
# each of 12 layers (attention at head dim 64 below 8192 keys takes the
# plain composition at eval)
PRED_LN_PER_FORWARD = 25
# a head-dim-128 BERT (BertConfig()'s width, hidden // 128 heads) at
# PRED_FLASH_LAYERS layers, exported and served at seq PRED_FLASH_SEQ with
# flash_attention_min_seq lowered to it: the eval route through the flash
# forward operator (the default gate admits head dim 128 at eval from
# 8192 keys); and the router called directly at PRED_FLASH_ROUTER
# [B, H, T, D] under no_grad with a [B, 1, 1, T] key-padding mask
PRED_FLASH_LAYERS = 2
PRED_FLASH_SEQ = 512
PRED_FLASH_BATCHES = (3,)
PRED_FLASH_ROUTER = (4, 6, 512, 128)
PATH_KERNELS.update({"predictor": ("layer_norm",),
                     "predictor_seq512": ("layer_norm",),
                     "predictor_bf16": ("layer_norm",),
                     "predictor_flash": ("layer_norm",
                                         "flash_attention_fwd"),
                     "predictor_wire": ("layer_norm",)})


def predictor_specs(jit, seq: int) -> list:
    return [jit.InputSpec([None, seq], "int64", name=n) for n in PRED_INPUTS]


def predictor_inputs(cfg, batch: int, seq: int, seed: int) -> list:
    """Token ids, token types and a ragged keep-mask (each row keeps a
    prefix of at least half the sequence), int64 numpy arrays."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq))
    types = rng.integers(0, 2, (batch, seq))
    keep = rng.integers(seq // 2, seq + 1, batch)
    mask = (np.arange(seq)[None, :] < keep[:, None]).astype(np.int64)
    return [ids.astype(np.int64), types.astype(np.int64), mask]


def bucket_of(buckets, batch: int) -> int:
    """The bucket a batch is padded to (a batch above the ladder runs as
    it is)."""
    return next((b for b in buckets if b >= batch), batch)


def pad_rows(arrs: list, to: int) -> list:
    """The predictor's padding: the last row repeated up to ``to``."""
    return [np.concatenate([a, np.repeat(a[-1:], to - a.shape[0], axis=0)])
            for a in arrs]


def eager_forward(torch, model, arrs: list) -> list:
    """The eager model's outputs on the card, on the host."""
    with torch.no_grad():
        out = model(*(torch.from_numpy(a).to(PRED_DEVICE) for a in arrs))
    return [o.cpu() for o in out]


def as_tensor(torch, a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def device_ms(torch, fn, iters: int = PRED_TIMING_ITERS) -> float:
    """Median device ms of ``fn`` (CUDA events around each call)."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def host_ms(torch, fn, iters: int = PRED_TIMING_ITERS) -> float:
    """Median host ms of ``fn`` followed by a synchronise."""
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def predictor_path(torch, pred, model, batches, seq: int, seed: int,
                   name: str, card: str, exact_tol: Optional[float] = TOL,
                   per_forward: Optional[dict] = None) -> tuple:
    """Runs each batch twice through ``pred`` (the first call of a new
    bucket is its warm-up and capture, every later one a replay), with
    the launch counts set to 0 before and read after; then holds each
    replay against the eager model at the padded batch (bit for bit,
    sliced) and at the exact batch (within ``exact_tol``; None: the gap
    is only reported), and times each bucket. Every call must launch
    ``per_forward`` (default: BERT-base's LayerNorms). Returns (report,
    launch counts of the path)."""
    from paddle_tpu_torch import kernels
    cfg = model.config
    buckets = pred.config.batch_buckets()
    runs, captures0 = [], pred.captures
    kernels.reset_launch_counts()
    for b in batches:
        arrs = predictor_inputs(cfg, b, seq, seed + b)
        cms0, c0 = pred.capture_ms, kernels.launch_counts()
        first = pred.run(arrs)
        c1 = kernels.launch_counts()
        again = pred.run(arrs)
        c2 = kernels.launch_counts()
        on_card = all(pred.get_output_handle(n)._value.device.type
                      == PRED_DEVICE for n in pred.get_output_names())
        runs.append(dict(batch=b, arrs=arrs, first=first, again=again,
                         first_launches=launch_delta(c0, c1),
                         replay_launches=launch_delta(c1, c2),
                         capture_ms=pred.capture_ms - cms0,
                         outputs_on_card=on_card))
    counts = kernels.launch_counts()
    per_forward = nonzero(per_forward if per_forward is not None
                          else {"layer_norm": PRED_LN_PER_FORWARD})
    report = {"seq": seq, "card": card, "buckets": {}}
    for r in runs:
        b = r["batch"]
        bucket = bucket_of(buckets, b)
        padded = eager_forward(torch, model, pad_rows(r["arrs"], bucket))
        exact = eager_forward(torch, model, r["arrs"])
        got = [as_tensor(torch, o) for o in r["again"]]
        first = [as_tensor(torch, o) for o in r["first"]]
        bitwise = all(torch.equal(g, p[:b]) for g, p in zip(got, padded))
        warm_equal = all(torch.equal(g, f) for g, f in zip(got, first))
        err = max(float((g.float() - e.float()).abs().max())
                  for g, e in zip(got, exact))
        graph = pred._shared.graphs[tuple(
            ((bucket, seq), torch.int64) for _ in PRED_INPUTS)]
        dev_pad = [torch.from_numpy(a).to(PRED_DEVICE)
                   for a in pad_rows(r["arrs"], bucket)]

        def eager_call():
            with torch.no_grad():
                model(*dev_pad)

        replay = device_ms(torch, graph.graph.replay)
        eager = device_ms(torch, eager_call)
        run_ms = host_ms(torch, lambda: pred.run(r["arrs"]))
        rec = {"batch": b, "bucket": bucket, "bitwise_padded": bitwise,
               "replay_equals_first_call": warm_equal,
               "max_abs_err_exact": err,
               "outputs_on_card": r["outputs_on_card"],
               "first_call_launches": r["first_launches"],
               "replay_launches": r["replay_launches"],
               "capture_ms": r["capture_ms"], "replay_ms_p50": replay,
               "eager_ms_p50": eager, "run_ms_p50": run_ms,
               "host_overhead_ms": run_ms - replay,
               "seqs_per_s": b / run_ms * 1e3,
               "bucket_seqs_per_s_device": bucket / replay * 1e3}
        report["buckets"][str(b)] = rec
        log(f"{name} batch {b} (bucket {bucket}) [{card}]: "
            f"{json.dumps(rec)}")
        if not (bitwise and warm_equal and r["outputs_on_card"]
                and (exact_tol is None or err <= exact_tol)
                and r["replay_launches"] == per_forward
                and r["first_launches"] == per_forward):
            raise AssertionError(f"{name} batch {b}: {rec}")
    touched = len({bucket_of(buckets, b) for b in batches})
    report["captures"] = pred.captures - captures0
    want = {k: n * 2 * len(batches) for k, n in per_forward.items()}
    if report["captures"] != touched or nonzero(counts) != want:
        raise AssertionError(f"{name}: {report['captures']} captures for "
                             f"{touched} buckets, launches {counts} (want "
                             f"{want})")
    return report, counts


@contextlib.contextmanager
def plain_layer_norm():
    """The LayerNorm kernel's plain version (``layer_norm_plain`` on the
    normalised dims merged into rows, plain PyTorch on any device) in the
    eval operator's place: a model's plain composition on the card."""
    from paddle_tpu_torch.kernels import custom_ops
    from paddle_tpu_torch.kernels import layer_norm as ln

    def plain(x, weight, bias, epsilon, begin_norm_axis):
        return ln.layer_norm_plain(
            x.flatten(begin_norm_axis), weight.reshape(-1),
            bias.reshape(-1), epsilon).reshape(x.shape)

    op = custom_ops.layer_norm
    custom_ops.layer_norm = plain
    try:
        yield
    finally:
        custom_ops.layer_norm = op


def predictor_bf16_against_plain(torch, pred, model, fp32_model, seq: int,
                                 seed: int) -> dict:
    """The bf16 predictor (LayerNorm's bf16 cast path through the
    operator) at PRED_BF16_BATCH against the same bf16 model's plain
    composition on the card (LayerNorm through ``layer_norm_plain``),
    both at the padded batch, sliced, and both against the fp32 model.
    Kernel and plain version differ by fp32 summation order, so a
    LayerNorm output now and then rounds to the other bf16 neighbour,
    and 12 layers carry such flips on as bf16 rounding noise: the two
    routes differ from each other by about as much as each differs from
    fp32. So each output of the predictor must lie within
    PRED_BF16_NOISE times the plain composition's own gap to the fp32
    model (each gap over the reference's largest entry); a wrong cast or
    scale lands at O(1). Every output bf16, and the plain run launching
    no kernel."""
    from paddle_tpu_torch import kernels

    def gap(got, want):
        return [float((g.float() - w.float()).abs().max()
                      / w.float().abs().max()) for g, w in zip(got, want)]

    arrs = predictor_inputs(model.config, PRED_BF16_BATCH, seq,
                            seed + PRED_BF16_BATCH)
    bucket = bucket_of(pred.config.batch_buckets(), PRED_BF16_BATCH)
    padded = pad_rows(arrs, bucket)
    got = [as_tensor(torch, o) for o in pred.run(arrs)]
    c0 = kernels.launch_counts()
    with plain_layer_norm():
        plain = [o[:PRED_BF16_BATCH] for o in
                 eager_forward(torch, model, padded)]
    plain_launches = launch_delta(c0, kernels.launch_counts())
    fp32 = [o[:PRED_BF16_BATCH] for o in
            eager_forward(torch, fp32_model, padded)]
    res = {"batch": PRED_BF16_BATCH, "bucket": bucket,
           "dtypes": [str(g.dtype) for g in got],
           "rel_err": gap(got, plain), "plain_rel_err_to_fp32":
           gap(plain, fp32), "rel_err_to_fp32": gap(got, fp32),
           "plain_launches": plain_launches}
    log(f"predictor bf16 against plain: {json.dumps(res)}")
    if any(g.dtype != torch.bfloat16 for g in got) or plain_launches \
            or any(e > PRED_BF16_NOISE * lim for e, lim in zip(
                res["rel_err_to_fp32"], res["plain_rel_err_to_fp32"])):
        raise AssertionError(f"predictor bf16 against plain: {res} "
                             f"(limit {PRED_BF16_NOISE}x the plain gap)")
    return res


def predictor_flash_router(torch) -> dict:
    """``kernels.maybe_flash_attention`` under no_grad at
    PRED_FLASH_ROUTER (head dim 128) with a ragged [B, 1, 1, T]
    key-padding mask, flash_attention_min_seq lowered to T, both layouts
    and both causal settings: the eval route through the flash forward
    operator, each call within FLASH_TOL of ``flash_attention_plain`` on
    the same inputs and launching exactly one flash forward (none on a
    CPU rehearsal)."""
    from paddle_tpu_torch import get_flags, kernels, set_flags
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, h, t, d = PRED_FLASH_ROUTER
    gen = torch.Generator(device=PRED_DEVICE).manual_seed(SEED + 93)
    keep = torch.randint(t // 2, t + 1, (b,), generator=gen,
                         device=PRED_DEVICE)
    mask = (torch.arange(t, device=PRED_DEVICE)[None, :]
            < keep[:, None])[:, None, None, :]
    bias = torch.where(mask[:, 0, 0, :], 0.0, fa.NEG_INF)
    per_call = nonzero({"flash_attention_fwd":
                        int(PRED_DEVICE == "cuda")})
    res = {}
    old = get_flags(["flash_attention_min_seq"])
    set_flags({"flash_attention_min_seq": t})
    try:
        for layout in ("bhtd", "bthd"):
            shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
            q, k, v = (torch.randn(shape, generator=gen,
                                   device=PRED_DEVICE) for _ in range(3))
            for causal in (False, True):
                c0 = kernels.launch_counts()
                with torch.no_grad():
                    got = kernels.maybe_flash_attention(
                        q, k, v, mask=mask, causal=causal, layout=layout)
                launched = launch_delta(c0, kernels.launch_counts())
                want = fa.flash_attention_plain(
                    q, k, v, causal=causal, kv_bias=bias,
                    bthd=layout == "bthd")
                e = {"max_abs_err": float((got - want).abs().max()),
                     "launches": launched,
                     "finite": bool(torch.isfinite(got).all())}
                res[f"{layout}_causal{int(causal)}"] = e
                if not (e["finite"] and e["max_abs_err"] <= FLASH_TOL
                        and launched == per_call
                        and got.shape == q.shape):
                    raise AssertionError(
                        f"flash router {layout} causal {causal}: {e} "
                        f"(limit {FLASH_TOL}, launches {per_call})")
    finally:
        set_flags(old)
    log(f"predictor flash router {list(PRED_FLASH_ROUTER)}: "
        f"{json.dumps(res)}")
    return res


def predictor_flash_model(torch, jit, inference, card: str) -> tuple:
    """A head-dim-128 BERT at PRED_FLASH_LAYERS layers, exported at
    [None, PRED_FLASH_SEQ] with flash_attention_min_seq lowered to the
    sequence (the gate is read while tracing, so the program holds the
    flash forward operator), served at PRED_FLASH_BATCHES: the same
    checks as BERT-base's path, with every call launching the
    LayerNorms and one flash forward a layer."""
    from paddle_tpu_torch import get_flags, set_flags
    from paddle_tpu_torch.models import BertConfig, BertModel
    base = BertConfig()
    cfg = BertConfig(num_hidden_layers=PRED_FLASH_LAYERS,
                     num_attention_heads=base.hidden_size // 128)
    gen = torch.Generator(device=PRED_DEVICE).manual_seed(SEED + 94)
    model = BertModel(cfg, device=PRED_DEVICE, generator=gen).eval()
    d = os.path.join(PRED_DIR, "bert_head_dim_128")
    per_forward = {}
    if PRED_DEVICE == "cuda":
        per_forward = {"layer_norm": 1 + 2 * PRED_FLASH_LAYERS,
                       "flash_attention_fwd": PRED_FLASH_LAYERS}
    old = get_flags(["flash_attention_min_seq"])
    set_flags({"flash_attention_min_seq": PRED_FLASH_SEQ})
    try:
        jit.save(model, d, input_spec=predictor_specs(jit, PRED_FLASH_SEQ))
        pred = inference.create_predictor(inference.Config(d))
        ops = [str(n.target) for n in pred._shared.module.graph.nodes]
        held = ops.count("paddle_tpu_torch.flash_attention.default")
        if held != PRED_FLASH_LAYERS:
            raise AssertionError(f"predictor_flash: the program holds "
                                 f"{held} flash operators, not "
                                 f"{PRED_FLASH_LAYERS}")
        return predictor_path(torch, pred, model, PRED_FLASH_BATCHES,
                              PRED_FLASH_SEQ, SEED + 83, "predictor_flash",
                              card, per_forward=per_forward)
    finally:
        set_flags(old)


def predictor_card_against_cpu(torch, model, jit, inference, seq: int,
                               card_out: list) -> dict:
    """The same weights exported on the CPU: loaded on the card (the
    program moved there whole, or refused naming its platform) and on
    the CPU; the card's result at PRED_CPU_BATCH held against the CPU
    predictor's, every output within GRAD_REL_TOL of its largest
    entry."""
    from paddle_tpu_torch.models import BertModel
    cfg = model.config
    arrs = predictor_inputs(cfg, PRED_CPU_BATCH, seq, SEED + 90)
    cpu_model = BertModel(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    d = os.path.join(PRED_DIR, "bert_base_cpu")
    t0 = time.perf_counter()
    jit.save(cpu_model, d, input_spec=predictor_specs(jit, seq))
    export_s = time.perf_counter() - t0
    res = {"batch": PRED_CPU_BATCH, "cpu_export_s": export_s}
    try:
        moved = inference.create_predictor(inference.Config(d))
        card = moved.run(arrs)
        res["cpu_export_on_card"] = "moved"
        res["moved_equals_card_export"] = all(
            torch.equal(as_tensor(torch, a), as_tensor(torch, b))
            for a, b in zip(card, card_out))
        del moved
    except ValueError as e:
        if "'cpu'" not in str(e):
            raise
        res["cpu_export_on_card"] = f"refused: {e}"
        card = card_out
    cpu_pred = inference.create_predictor(inference.Config(d, device="cpu"))
    t0 = time.perf_counter()
    cpu = cpu_pred.run(arrs)
    res["cpu_run_s"] = time.perf_counter() - t0
    res["rel_err"] = [float(np.abs(a - c).max() / np.abs(c).max())
                      for a, c in zip(card, cpu)]
    log(f"predictor card against CPU: {json.dumps(res)}")
    if max(res["rel_err"]) > GRAD_REL_TOL \
            or res.get("moved_equals_card_export") is False:
        raise AssertionError(f"predictor card against CPU: {res}")
    return res


def predictor_clone(torch, pred, cfg, seq: int) -> dict:
    """``clone()`` shares the weights, graphs and lock: it allocates
    nothing, its run captures nothing new and equals the parent's."""
    arrs = predictor_inputs(cfg, PRED_CPU_BATCH, seq, SEED + 91)
    want = pred.run(arrs)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    clone = pred.clone()
    clone_bytes = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    caps = pred.captures
    got = clone.run(arrs)
    peak = torch.cuda.max_memory_allocated() - base
    weights = sum(t.numel() * t.element_size()
                  for t in pred._shared.params.values())
    res = {"clone_alloc_bytes": clone_bytes, "run_peak_delta_bytes": peak,
           "weights_bytes": weights,
           "shares": clone._shared is pred._shared,
           "new_captures": pred.captures - caps,
           "equal": all(torch.equal(as_tensor(torch, a),
                                    as_tensor(torch, b))
                        for a, b in zip(got, want))}
    log(f"predictor clone: {json.dumps(res)}")
    if clone_bytes != 0 or peak > 0.01 * weights or not res["shares"] \
            or res["new_captures"] or not res["equal"]:
        raise AssertionError(f"predictor clone: {res}")
    return res


def predictor_wire(torch, pred, cfg, seq: int, max_batch: int, wait_ms: int,
                   clients: int, requests: int, lo: int, hi: int) -> tuple:
    """``Server(pred)`` answering ``clients`` threads of ``requests``
    requests each (``lo``..``hi`` rows): every reply within TOL of
    ``pred.run`` on that request alone, batches formed (the native
    ``serving.*`` stats), a malformed request answered with its
    ``decode_error`` and the loop still serving. Returns (report,
    launch counts of the server's runs)."""
    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import Client, Server
    rng = np.random.default_rng(SEED + 92)
    reqs = [[predictor_inputs(cfg, int(rng.integers(lo, hi + 1)), seq,
                              SEED + 1000 + 100 * c + i)
             for i in range(requests)] for c in range(clients)]
    want = [[pred.run(r) for r in rs] for rs in reqs]
    set_flags({"enable_metrics": True, "metrics_port": -1})
    try:
        srv = Server(pred, max_batch=max_batch, wait_ms=wait_ms)
        try:
            with Client(port=srv.port) as cli:
                stats0 = cli.stats()
            got = [[None] * requests for _ in range(clients)]
            lat = []

            def client(c):
                with Client(port=srv.port) as cli:
                    for i, r in enumerate(reqs[c]):
                        t0 = time.perf_counter()
                        got[c][i] = cli.infer(r)
                        lat.append((time.perf_counter() - t0) * 1e3)

            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(clients) as pool:
                list(pool.map(client, range(clients)))
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            batches = srv.n_batches
            with Client(port=srv.port) as cli:
                stats1 = cli.stats()
                try:
                    cli.infer([np.float32(1.0).reshape(())])
                    malformed = "answered"
                except RuntimeError as e:
                    malformed = str(e)
                after = cli.infer(reqs[0][0])
        finally:
            srv.stop()
        outcomes = [s["outcome"] for s in obs.reqtrace.recent()]
    finally:
        set_flags({"enable_metrics": False, "metrics_port": 0})
        obs.reset_all()
    err = max(float(np.abs(g - w).max()) for gs, ws in zip(got, want)
              for gr, wr in zip(gs, ws) for g, w in zip(gr, wr))
    delta = {k: stats1.get(k, 0) - stats0.get(k, 0) for k in stats1
             if k.startswith("serving.batch")}
    n = clients * requests
    res = {"requests": n, "max_batch": max_batch, "wait_ms": wait_ms,
           "max_abs_err": err, "batches": batches, "stats": delta,
           "requests_per_s": n / wall,
           "latency_ms_p50": float(np.percentile(lat, 50)),
           "latency_ms_p99": float(np.percentile(lat, 99)),
           "malformed_reply": malformed,
           "decode_errors": outcomes.count("decode_error"),
           "ok_spans": outcomes.count("ok"),
           "served_after_malformed": all(
               np.array_equal(a, b) for a, b in zip(after, want[0][0]))}
    log(f"predictor wire: {json.dumps(res)}")
    multi_row = delta.get("serving.batches_total", 0) \
        - delta.get("serving.batch_size_le_4", 0)
    if err > TOL or batches >= n or delta.get(
            "serving.batches_total") != batches or multi_row <= 0 \
            or "leading batch dim" not in malformed \
            or res["decode_errors"] != 1 or res["ok_spans"] < n \
            or not res["served_after_malformed"] \
            or nonzero(counts) != nonzero(
                {"layer_norm": PRED_LN_PER_FORWARD * batches}):
        raise AssertionError(f"predictor wire: {res}, launches {counts}")
    return res, counts


def run_predictor(torch) -> tuple:
    """Phase 9. Returns (report, launch counts of each path)."""
    import copy
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import BertConfig, BertModel
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    report, counts = {}, {}
    shutil.rmtree(PRED_DIR, ignore_errors=True)
    try:
        cfg = BertConfig()
        gen = torch.Generator(device=PRED_DEVICE).manual_seed(SEED)
        model = BertModel(cfg, device=PRED_DEVICE, generator=gen).eval()
        exports = {}

        def export(m, name, seq):
            d = os.path.join(PRED_DIR, name)
            t0 = time.perf_counter()
            jit.save(m, d, input_spec=predictor_specs(jit, seq))
            exports[name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            pred = inference.create_predictor(inference.Config(d))
            exports[name + "_load"] = time.perf_counter() - t0
            return pred

        pred = export(model, "bert_base", PRED_SEQ)
        report["predictor"], counts["predictor"] = predictor_path(
            torch, pred, model, PRED_BATCHES, PRED_SEQ, SEED + 80,
            "predictor", card)
        ref = predictor_inputs(cfg, PRED_CPU_BATCH, PRED_SEQ, SEED + 90)
        report["predictor_card_vs_cpu"] = predictor_card_against_cpu(
            torch, model, jit, inference, PRED_SEQ, pred.run(ref))
        report["predictor_clone"] = predictor_clone(torch, pred, cfg,
                                                    PRED_SEQ)
        report["predictor_wire"], counts["predictor_wire"] = \
            predictor_wire(torch, pred, cfg, PRED_SEQ, **PRED_WIRE)
        del pred
        pred512 = export(model, "bert_base_seq512", 512)
        report["predictor_seq512"], counts["predictor_seq512"] = \
            predictor_path(torch, pred512, model, PRED_SEQ512_BATCHES, 512,
                           SEED + 81, "predictor_seq512", card)
        del pred512
        bf16 = cast_model_to_low_precision(copy.deepcopy(model), "bfloat16")
        pred_bf16 = export(bf16, "bert_base_bf16", PRED_SEQ)
        report["predictor_bf16"], counts["predictor_bf16"] = \
            predictor_path(torch, pred_bf16, bf16, (PRED_BF16_BATCH,),
                           PRED_SEQ, SEED + 82, "predictor_bf16", card,
                           exact_tol=None)
        report["predictor_bf16_vs_plain"] = predictor_bf16_against_plain(
            torch, pred_bf16, bf16, model, PRED_SEQ, SEED + 82)
        del pred_bf16, bf16, model
        report["predictor_flash_router"] = predictor_flash_router(torch)
        report["predictor_flash"], counts["predictor_flash"] = \
            predictor_flash_model(torch, jit, inference, card)
        report["predictor_exports_s"] = exports
        report["predictor_peak_gib"] = torch.cuda.max_memory_allocated() \
            / 2 ** 30
        report["predictor_phase_s"] = time.perf_counter() - t_phase
        log(f"predictor: exports {json.dumps(exports)}, peak "
            f"{report['predictor_peak_gib']:.3f} GiB, phase "
            f"{report['predictor_phase_s']:.1f} s [{card}]")
    finally:
        shutil.rmtree(PRED_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    return report, counts


# ---------------------------------------------------------------------------
# phase 10: hapi.Model over BERT pretraining, the export and the verify entry
# ---------------------------------------------------------------------------

# BERT-base bf16 pretraining through Model.fit as the JAX bench builds it
# (the fused flags over the flat fused state), b8 x s512 from
# HAPI_SAMPLES samples (4 batches an epoch), HAPI_EPOCHS epochs; run 2 of
# the interrupted fit resumes at HAPI_SAVE_AT; the metrics-on fit and the
# divergence drill at HAPI_SMALL_LAYERS
HAPI_SAMPLES, HAPI_EPOCHS, HAPI_SAVE_AT = 32, 2, 4
HAPI_LAYERS, HAPI_SMALL_LAYERS = 12, 2
HAPI_DRILL_BATCHES = 10
# the drill: NaN losses at the 4th-6th step, a streak of 3 trips the
# watchdog, one rollback allowed
HAPI_DRILL_SPEC = ("loss_spike:at=4:mul=nan,loss_spike:at=5:mul=nan,"
                   "loss_spike:at=6:mul=nan")
HAPI_DRILL_FLAGS = {"divergence_streak": 3, "rollback_budget": 1}
# Model(BertModel(BertConfig())).save(training=False) at [None, 128],
# served at batch 3 (its bucket 4)
HAPI_EXPORT_SEQ, HAPI_EXPORT_BATCH = 128, 3
HAPI_DEVICE = "cuda"
# BertConfig overrides (none: BERT-base; a CPU rehearsal shrinks it)
HAPI_CFG: dict = {}
HAPI_ALL_KERNELS = ("layer_norm", "paged_attention",
                    "paged_attention_multiquery", "flash_attention_fwd",
                    "flash_attention_bwd_fused", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "fused_xent_fwd",
                    "fused_xent_bwd_dlog", "fused_xent_bwd_dh",
                    "fused_xent_bwd_dw", "adam_leaf", "adam_flat")
PATH_KERNELS.update({
    "hapi_fit": PATH_KERNELS["train_seq512_bf16_fused"],
    "hapi_fit_resumed": PATH_KERNELS["train_seq512_bf16_fused"],
    "hapi_fit_metrics": PATH_KERNELS["train_seq512_bf16_fused"],
    "hapi_rollback": PATH_KERNELS["train_seq512_bf16_fused"],
    # evaluate: the eval forward's LayerNorms (attention below the eval
    # flash floor is plain) and the fused loss's forward
    "hapi_eval": ("layer_norm", "fused_xent_fwd"),
    "hapi_predict": ("layer_norm",),
    "hapi_export": ("layer_norm",),
    # verify holds every kernel against its plain version
    "hapi_verify": HAPI_ALL_KERNELS})


class PackedSamples:
    """PretrainSamples for ``hapi``'s one-label contract: the inputs (ids,
    types, mask, masked positions) and ONE int64 label ``[RESUME_MASKED +
    1]``, the MLM labels followed by the NSP label."""

    def __init__(self, base: PretrainSamples) -> None:
        self.base = base

    def __getitem__(self, i):
        ids, types, mask, pos, mlm, nsp = self.base[i]
        return ids, types, mask, pos, np.append(mlm, nsp).astype(np.int64)

    def __len__(self):
        return len(self.base)


def packed_loss(out, label):
    """``pretraining_loss`` over the packed label."""
    from paddle_tpu_torch.models import pretraining_loss
    return pretraining_loss(out, label[:, :-1], label[:, -1])


def hapi_bert(torch, layers: int, dtype: str = "bfloat16"):
    """BertForPretraining (dropout 0.1) from SEED on HAPI_DEVICE, cast as
    the JAX bench casts it."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    model = BertForPretraining(BertConfig(num_hidden_layers=layers,
                                          **HAPI_CFG),
                               device=HAPI_DEVICE, seed=SEED)
    if dtype != "float32":
        model = cast_model_to_low_precision(model, dtype)
    return model


def hapi_model(net, metrics=None):
    """``hapi.Model`` over ``net`` with the bench's AdamW(1e-4,
    weight_decay=0.01) over the flat fused state and the packed loss."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    return Model(net, loss=packed_loss, metrics=metrics,
                 optimizer=AdamW(1e-4, weight_decay=0.01, fused_state=True))


def hapi_recorder(torch):
    """A callback keeping each step's loss (a device tensor) and, on the
    card, an event recorded after it on the current stream."""
    from paddle_tpu_torch.hapi import Callback

    class Recorder(Callback):
        def __init__(self) -> None:
            self.losses, self.events = [], []

        def on_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            if HAPI_DEVICE == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)

    return Recorder()


def steady_step_ms(events: list, per_epoch: int) -> Optional[float]:
    """The median stream ms of steps 2..per_epoch of each epoch (the gap
    between the events after consecutive steps); None without events."""
    if not events:
        return None
    events[-1].synchronize()
    gaps = [events[k - 1].elapsed_time(events[k])
            for k in range(1, len(events)) if k % per_epoch]
    return float(np.median(gaps))


def hapi_samples(torch, cfg, seed: int) -> PretrainSamples:
    return PretrainSamples(HAPI_SAMPLES, RESUME_SEQ, cfg.vocab_size, seed)


def hapi_fit_resume(torch, card: str) -> tuple:
    """(a): BERT-base bf16 fused through ``Model.fit``: HAPI_EPOCHS
    epochs uninterrupted; one epoch with ``ckpt_dir`` and ``save_steps=
    HAPI_SAVE_AT`` then a fresh Model over the same directory for
    HAPI_EPOCHS epochs (it restores step HAPI_SAVE_AT and re-enters
    through ``iter_from``); the same batches through a bare
    ``TrainStep``. Losses, parameters, masters, moments, step counter and
    generator bit for bit alike in all three; launches the per-step
    counts times the steps. Returns (report, counts, the uninterrupted
    Model, the samples)."""
    from paddle_tpu_torch import io, kernels
    d = os.path.join(CKPT_DIR, "hapi_fit")
    shutil.rmtree(d, ignore_errors=True)
    counts, t_run = {}, {}
    net = hapi_bert(torch, HAPI_LAYERS)
    cfg = net.config
    base = hapi_samples(torch, cfg, SEED + 100)
    ds = PackedSamples(base)
    per_epoch = HAPI_SAMPLES // RESUME_BATCH
    steps = HAPI_EPOCHS * per_epoch
    # uninterrupted
    kernels.reset_launch_counts()
    model = hapi_model(net)
    rec_u = hapi_recorder(torch)
    t0 = time.perf_counter()
    hist_u = model.fit(make_loader(torch, ds), epochs=HAPI_EPOCHS, verbose=0,
                       callbacks=[rec_u])
    t_run["uninterrupted_s"] = time.perf_counter() - t0
    counts["hapi_fit"] = kernels.launch_counts()
    end_u = state_on_host(model._train_step)
    losses_u = [float(x) for x in rec_u.losses]
    # interrupted after one epoch, resumed by a fresh Model
    kernels.reset_launch_counts()
    m1 = hapi_model(hapi_bert(torch, HAPI_LAYERS))
    rec1 = hapi_recorder(torch)
    t0 = time.perf_counter()
    m1.fit(make_loader(torch, ds), epochs=1, verbose=0, ckpt_dir=d,
           save_steps=HAPI_SAVE_AT, callbacks=[rec1])
    t_run["interrupted_s"] = time.perf_counter() - t0
    ck = io.AsyncCheckpointer(d)
    saved_at, host_state = ck.intact_steps(), ck.host_state()
    del m1
    m2 = hapi_model(hapi_bert(torch, HAPI_LAYERS))
    rec2 = hapi_recorder(torch)
    t0 = time.perf_counter()
    hist_r = m2.fit(make_loader(torch, ds), epochs=HAPI_EPOCHS, verbose=0,
                    ckpt_dir=d, save_steps=HAPI_SAVE_AT, callbacks=[rec2])
    t_run["resumed_s"] = time.perf_counter() - t0
    counts["hapi_fit_resumed"] = kernels.launch_counts()
    end_r = state_on_host(m2._train_step)
    kept = ck.intact_steps()
    losses_r = [float(x) for x in rec1.losses + rec2.losses]
    del m2
    shutil.rmtree(d, ignore_errors=True)
    # the same batches through a bare TrainStep, staged on the card first
    loader = make_loader(torch, base)
    batches = [tuple(t.to(HAPI_DEVICE) for t in b)
               for _ in range(HAPI_EPOCHS) for b in loader]
    step = make_train_step(hapi_bert(torch, HAPI_LAYERS), fused_state=True)
    events, losses_b = [], []
    for ids, types, mask, pos, mlm, nsp in batches:
        losses_b.append(step(ids, types, mask, pos, labels=(mlm, nsp))["loss"])
        if HAPI_DEVICE == "cuda":
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
    losses_b = [float(x) for x in losses_b]
    end_b = state_on_host(step)
    bare_ms = steady_step_ms(events, per_epoch)
    del step, batches
    differ_r = equal_states(torch, end_u, end_r)
    differ_b = equal_states(torch, end_u, end_b)
    per_step = expected_launches(RESUME_SEQ, HAPI_LAYERS,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 FUSED_FLAGS,
                                 rows=RESUME_BATCH * RESUME_MASKED,
                                 vocab=cfg.vocab_size)
    fit_ms = steady_step_ms(rec_u.events, per_epoch)
    res = {"layers": HAPI_LAYERS, "dtype": "bfloat16", "batch": RESUME_BATCH,
           "seq": RESUME_SEQ, "steps": steps, "saved_at": saved_at,
           "host_state": host_state, "checkpoints_kept": kept,
           "losses_fit": losses_u, "losses_fit_resumed": losses_r,
           "losses_train_step": losses_b, "history": hist_u,
           "history_resumed": hist_r,
           "state_leaves": len(end_u),
           "resumed_leaves_differing": differ_r,
           "train_step_leaves_differing": differ_b,
           "fit_step_ms_median": fit_ms, "train_step_ms_median": bare_ms,
           "fit_over_train_step": None if not bare_ms else fit_ms / bare_ms,
           "card": card, **t_run}
    log(f"hapi fit: {json.dumps(res)}")
    if losses_r != losses_u or losses_b != losses_u or differ_r or differ_b \
            or saved_at != [HAPI_SAVE_AT] or kept[-1] != steps \
            or host_state["batch_in_epoch"] != HAPI_SAVE_AT - 1 \
            or len(losses_u) != steps:
        raise AssertionError(f"hapi fit: {res}")
    for path in ("hapi_fit", "hapi_fit_resumed"):
        path_launches(path, counts[path], per_step, steps)
    return res, counts, model, base


def hapi_eval_predict(torch, model, base) -> tuple:
    """(b): ``Model.evaluate`` with the loss and an NSP-accuracy metric
    through the deferred ``compute`` path, against a loop of ``EvalStep``
    over the same batches (bit for bit), under the fused flags; then
    ``Model.predict`` (the lag-1 path, default flags) against the same
    loop's outputs on the host, bit for bit. Returns (report, counts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.data import DataLoader
    from paddle_tpu_torch.metric import Metric
    from paddle_tpu_torch.ops import metrics_ops
    from paddle_tpu_torch.static import EvalStep

    class NspAccuracy(Metric):
        """NSP accuracy: the device half computes, the host accumulates
        the batch means."""

        def __init__(self) -> None:
            self.reset()

        def reset(self) -> None:
            self.total, self.count = 0.0, 0

        def compute(self, out, label):
            return metrics_ops.accuracy(out[1], label[:, -1])

        def update(self, correct) -> None:
            self.total += float(correct)
            self.count += 1

        def accumulate(self):
            return self.total / max(self.count, 1)

    ds = PackedSamples(base)
    loader = DataLoader(ds, batch_size=RESUME_BATCH)
    batches = [tuple(t.to(HAPI_DEVICE) for t in b) for b in loader]
    counts = {}
    model.prepare(metrics=[NspAccuracy()])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = model.evaluate(loader, verbose=0)
    eval_s = time.perf_counter() - t0
    counts["hapi_eval"] = kernels.launch_counts()
    ev = EvalStep(model.network)
    losses, accs = [], []
    for *inputs, label in batches:
        out, _ = ev(None, None, *inputs)
        with torch.no_grad():
            losses.append(packed_loss(out, label))
        accs.append(float(metrics_ops.accuracy(out[1], label[:, -1])))
    want = {"eval_loss": float(torch.stack([v.float() for v in losses])
                               .mean()),
            "eval_nspaccuracy": sum(accs) / len(accs)}
    restore = flag_scope({k: False for k in FUSED_FLAGS})
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        preds = model.predict(loader)
        predict_s = time.perf_counter() - t0
        counts["hapi_predict"] = kernels.launch_counts()
        refs = [ev(None, None, *b[:-1])[0] for b in batches]
        same_pred = len(preds) == len(refs) and all(
            len(p) == len(r) and all(
                np.array_equal(pp, rr.float().cpu().numpy())
                for pp, rr in zip(p, r)) for p, r in zip(preds, refs))
        shapes = [[list(a.shape) for a in p] for p in preds[:1]]
    finally:
        restore()
    del ev, refs, preds, batches
    layers = model.network.config.num_hidden_layers
    n = len(losses)
    ln = 2 * layers + 2
    res = {"evaluate": got, "eval_step_loop": want, "eval_s": eval_s,
           "evaluate_equal": got == want, "predict_batches": n,
           "predict_equal": same_pred, "predict_shapes": shapes,
           "predict_s": predict_s}
    log(f"hapi evaluate/predict: {json.dumps(res)}")
    if got != want or not same_pred:
        raise AssertionError(f"hapi evaluate/predict: {res}")
    path_launches("hapi_eval", nonzero(counts["hapi_eval"]),
                  {"layer_norm": ln, "fused_xent_fwd": 2}, n)
    path_launches("hapi_predict", nonzero(counts["hapi_predict"]),
                  {"layer_norm": ln}, n)
    return res, counts


def hapi_export(torch, card: str) -> tuple:
    """(c): ``Model(BertModel(BertConfig())).save(path, training=False,
    input_spec=[InputSpec([None, 128])])`` -> ``create_predictor``; a
    batch of HAPI_EXPORT_BATCH run twice, each output bit for bit the
    eager forward at the padded bucket, one forward's LayerNorms a call.
    Returns (report, counts)."""
    from paddle_tpu_torch import inference, jit, kernels
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import BertConfig, BertModel
    path = os.path.join(PRED_DIR, "hapi_bert_base")
    shutil.rmtree(path, ignore_errors=True)
    try:
        cfg = BertConfig(**HAPI_CFG)
        gen = torch.Generator(device=HAPI_DEVICE).manual_seed(SEED)
        net = BertModel(cfg, device=HAPI_DEVICE, generator=gen)
        t0 = time.perf_counter()
        Model(net).save(path, training=False, input_spec=[jit.InputSpec(
            [None, HAPI_EXPORT_SEQ], "int64", name="input_ids")])
        save_s = time.perf_counter() - t0
        pred = inference.create_predictor(inference.Config(path))
        ids = predictor_inputs(cfg, HAPI_EXPORT_BATCH, HAPI_EXPORT_SEQ,
                               SEED + 110)[:1]
        kernels.reset_launch_counts()
        first = [as_tensor(torch, o) for o in pred.run(ids)]
        again = [as_tensor(torch, o) for o in pred.run(ids)]
        counts = {"hapi_export": kernels.launch_counts()}
        bucket = bucket_of(pred.config.batch_buckets(), HAPI_EXPORT_BATCH)
        net.eval()
        with torch.no_grad():
            padded = [o.cpu() for o in net(torch.from_numpy(
                pad_rows(ids, bucket)[0]).to(HAPI_DEVICE))]
        bitwise = all(torch.equal(a.cpu(), p[:HAPI_EXPORT_BATCH])
                      and torch.equal(b.cpu(), p[:HAPI_EXPORT_BATCH])
                      for a, b, p in zip(first, again, padded))
        res = {"seq": HAPI_EXPORT_SEQ, "batch": HAPI_EXPORT_BATCH,
               "bucket": bucket, "bitwise_padded": bitwise,
               "outputs": len(padded), "save_s": save_s, "card": card}
        log(f"hapi export: {json.dumps(res)}")
        if not bitwise or len(first) != len(padded):
            raise AssertionError(f"hapi export: {res}")
        path_launches("hapi_export", nonzero(counts["hapi_export"]),
                      {"layer_norm": 2 * cfg.num_hidden_layers + 1}, 2)
        del pred, net
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return res, counts


def hapi_metrics_and_drill(torch) -> tuple:
    """(d): one ``fit`` at HAPI_SMALL_LAYERS with ``enable_metrics`` on
    (the step histogram counts its steps, the goodput ledger holds
    ``step_compute`` and ``data_wait``); then the divergence drill at
    the same depth: ``HAPI_DRILL_SPEC`` (NaN losses), ``rollback_budget``
    1, a checkpoint every step: one rollback, the fit runs on to its end
    from the checkpoint with every parameter finite. Returns (report,
    counts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.testing import faults
    d = os.path.join(CKPT_DIR, "hapi_drill")
    shutil.rmtree(d, ignore_errors=True)
    counts = {}
    restore = flag_scope({"enable_metrics": True, "metrics_port": -1,
                          **HAPI_DRILL_FLAGS})
    obs.reset_all()
    try:
        net = hapi_bert(torch, HAPI_SMALL_LAYERS)
        cfg = net.config
        base = hapi_samples(torch, cfg, SEED + 120)
        per_step = expected_launches(
            RESUME_SEQ, HAPI_SMALL_LAYERS,
            cfg.hidden_size // cfg.num_attention_heads, FUSED_FLAGS,
            rows=RESUME_BATCH * RESUME_MASKED, vocab=cfg.vocab_size)
        kernels.reset_launch_counts()
        hist = hapi_model(net).fit(make_loader(torch, PackedSamples(base)),
                                   epochs=1, verbose=0)
        counts["hapi_fit_metrics"] = kernels.launch_counts()
        steps = HAPI_SAMPLES // RESUME_BATCH
        observed = obs.registry().get("hapi_step_time_seconds").count()
        ledger = obs.goodput_ledger().snapshot()["buckets"]
        prom = obs.registry().prometheus_text()
        series = [name for name in (
            "hapi_step_time_seconds", "hapi_throughput_items_per_sec",
            "hapi_loss", "device_mem_bytes_in_use", "memory_headroom_bytes",
            "train_heartbeat_timestamp_seconds") if name not in prom]
        metrics_res = {"history": hist, "steps_observed": observed,
                       "ledger_buckets": ledger, "series_missing": series}
        log(f"hapi metrics on: {json.dumps(metrics_res)}")
        if observed != steps or ledger["step_compute"] <= 0 \
                or ledger["data_wait"] <= 0 or series:
            raise AssertionError(f"hapi metrics on: {metrics_res}")
        path_launches("hapi_fit_metrics", counts["hapi_fit_metrics"],
                      per_step, steps)
        # the drill: a plain list of batches (no iter_from: the resume
        # replays the stream past the checkpoint)
        packed = PackedSamples(hapi_samples(torch, cfg, SEED + 130))
        from paddle_tpu_torch.data import default_collate_fn
        batches = [tuple(np.asarray(a) for a in default_collate_fn(
            [packed[j % len(packed)] for j in range(i * RESUME_BATCH,
                                                    (i + 1) * RESUME_BATCH)]))
            for i in range(HAPI_DRILL_BATCHES)]
        rollbacks = obs.counter("rollbacks_total", always=True)
        before = rollbacks.value()
        rec = hapi_recorder(torch)
        drill_net = hapi_bert(torch, HAPI_SMALL_LAYERS)
        faults.configure(HAPI_DRILL_SPEC)
        kernels.reset_launch_counts()
        try:
            drill_hist = hapi_model(drill_net).fit(
                batches, epochs=1, verbose=0, ckpt_dir=d, save_steps=1,
                callbacks=[rec])
        finally:
            faults.configure(None)
        counts["hapi_rollback"] = kernels.launch_counts()
        events = {e["kind"]: e for e in obs.flight_recorder().events()
                  if e["kind"] in ("fit_rollback", "fit_rollback_resume")}
        finite = all(bool(torch.isfinite(p).all())
                     for p in drill_net.parameters())
        losses = [float(x) for x in rec.losses]
        tripped_at = events.get("fit_rollback", {}).get("at_step")
        resumed_at = events.get("fit_rollback_resume", {}).get(
            "resume_step")
        drill = {"spec": HAPI_DRILL_SPEC, "flags": HAPI_DRILL_FLAGS,
                 "rollbacks": rollbacks.value() - before,
                 "tripped_after_step": tripped_at,
                 "resumed_from_checkpoint": resumed_at,
                 "steps_run": len(losses), "losses": losses,
                 "history": drill_hist, "params_finite": finite}
        log(f"hapi divergence drill: {json.dumps(drill)}")
        # every step after the checkpoint it went back to runs again
        if drill["rollbacks"] != 1 or not finite or tripped_at is None \
                or resumed_at is None or resumed_at > tripped_at \
                or len(losses) != HAPI_DRILL_BATCHES + tripped_at \
                - resumed_at or not np.isfinite(losses[-1]):
            raise AssertionError(f"hapi divergence drill: {drill}")
        path_launches("hapi_rollback", counts["hapi_rollback"], per_step,
                      len(losses))
    finally:
        restore()
        obs.reset_all()
        shutil.rmtree(d, ignore_errors=True)
    return {"metrics_on": metrics_res, "divergence_drill": drill}, counts


def hapi_verify(torch) -> tuple:
    """(e): ``paddle_tpu_torch.verify.run_verification()`` on the card:
    ok, its artifact written, every kernel launched. Returns (report,
    counts)."""
    from paddle_tpu_torch import kernels, verify
    path = verify.default_artifact_path()
    if os.path.exists(path):
        os.remove(path)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = verify.run_verification()
    seconds = time.perf_counter() - t0
    counts = {"hapi_verify": kernels.launch_counts()}
    with open(path) as f:
        written = json.load(f)
    out = dict(res, seconds=seconds, artifact=path,
               artifact_equal=written == json.loads(json.dumps(res)))
    log(f"hapi verify: {json.dumps(out)}")
    if not res["ok"] or not out["artifact_equal"]:
        raise AssertionError(f"hapi verify: {out}")
    return out, counts


def run_hapi(torch) -> tuple:
    """Phase 10. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    restore = flag_scope(FUSED_FLAGS)
    try:
        report["hapi_fit"], c, model, base = hapi_fit_resume(torch, card)
        counts.update(c)
        report["hapi_eval_predict"], c = hapi_eval_predict(torch, model,
                                                           base)
        counts.update(c)
        del model
        if HAPI_DEVICE == "cuda":
            torch.cuda.empty_cache()
        report["hapi_metrics"], c = hapi_metrics_and_drill(torch)
        counts.update(c)
    finally:
        restore()
    report["hapi_export"], c = hapi_export(torch, card)
    counts.update(c)
    report["hapi_verify"], c = hapi_verify(torch)
    counts.update(c)
    report["hapi_phase_s"] = time.perf_counter() - t_phase
    log(f"hapi phase: {report['hapi_phase_s']:.1f} s [{card}]")
    return report, counts


# phase 11: Transformer-base translation (Vaswani et al. 2017, Table 3
# "base": d 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, ~37k
# shared-BPE vocabulary of WMT14 en-de; separate source and target tables,
# as the JAX model builds them), fed the industrial way: slot files ->
# InMemoryDataset -> Model.fit
MT_CFG = dict(src_vocab=37000, tgt_vocab=37000, d_model=512, nhead=8,
              num_encoder_layers=6, num_decoder_layers=6,
              dim_feedforward=2048, dropout=0.1, max_len=256)
MT_SRC, MT_TGT, MT_BATCH = 256, 224, 32
MT_EPOCHS, MT_STEPS = 2, 4  # steps an epoch
MT_THREADS, MT_FILES = 2, 2
# the training flash gate of the phase (the default 512 would send these
# lengths to the plain composition), as phase 4's b32 s128 run lowers it
MT_GATE = 128
MT_DEVICE = "cuda"
MT_DIR = "chip_smoke_mt"  # the slot files (removed after the phase)
MT_CPU_LAYERS = 2  # (b): the card against the CPU at full width
MT_CPU_BATCH = 4
MT_BEAM = dict(beam_size=4, sources=4, max_len=64)
MT_BEAM_SCORE_TOL = 1e-4
# (d): BERT-base bf16 fused over the flat fused state, 3 captured steps,
# transformer_remat off against on
REMAT_STEPS = 3
# (e): nn.Transformer at the reference defaults, pre-norm
PRENORM_CFG = dict(d_model=512, nhead=8, num_encoder_layers=6,
                   num_decoder_layers=6, dim_feedforward=2048)
PRENORM_BATCH = 4
MT_KERNELS = ("layer_norm", "flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")
PATH_KERNELS.update({"mt_fit": MT_KERNELS,
                     "remat_off": PATH_KERNELS["train_seq512_bf16_fused"],
                     "remat_on": PATH_KERNELS["train_seq512_bf16_fused"],
                     "prenorm": MT_KERNELS})


def mt_records(n: int, seed: int) -> tuple:
    """``n`` full-length translation records from numpy ``seed``: source
    ids ``[n, MT_SRC]``, the target ``[n, MT_TGT]`` as labels and the
    decoder input (BOS, then the target shifted right); ids 3.. (0-2 are
    pad, BOS and EOS)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, MT_CFG["src_vocab"], (n, MT_SRC))
    labels = rng.integers(3, MT_CFG["tgt_vocab"], (n, MT_TGT))
    tgt_in = np.concatenate([np.ones((n, 1), np.int64), labels[:, :-1]],
                            axis=1)
    return src, tgt_in, labels


def mt_slot_files(torch, directory: str) -> list:
    """The phase's records written by a ``MultiSlotDataGenerator`` into
    MT_FILES slot files (3 sparse slots: src, tgt_in, labels)."""
    from paddle_tpu_torch.data.data_generator import MultiSlotDataGenerator
    n = MT_BATCH * MT_STEPS
    src, tgt_in, labels = mt_records(n, SEED)

    class Records(MultiSlotDataGenerator):
        def generate_sample(self, line):
            i = int(line)

            def it():
                yield [("src", src[i].tolist()),
                       ("tgt_in", tgt_in[i].tolist()),
                       ("labels", labels[i].tolist())]
            return it

    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    files = []
    for part in range(MT_FILES):
        inp = os.path.join(directory, f"index-{part}.txt")
        with open(inp, "w") as f:
            f.writelines(f"{i}\n" for i in range(part, n, MT_FILES))
        out = os.path.join(directory, f"part-{part}")
        Records().run_from_files([inp], out)
        files.append(out)
    return files


class MTBatches:
    """An ``InMemoryDataset``'s batches as ``Model.fit`` takes them:
    ``(src, tgt_in, labels)`` numpy arrays, each epoch from memory."""

    def __init__(self, ds) -> None:
        self.ds = ds

    def __iter__(self):
        for b in self.ds:
            yield b["src"], b["tgt_in"], b["labels"]


def mt_loss(logits, labels):
    """The JAX example's loss (``examples/machine_translation.py``): mean
    softmax cross-entropy over every target position."""
    from paddle_tpu_torch.ops.loss import cross_entropy
    return cross_entropy(logits, labels)


def mt_launches(enc: int, dec: int, src: int, tgt: int, d: int,
                prenorm: bool = False) -> dict:
    """Kernel launches of one forward and backward of the seq2seq stack in
    training with the flash gate at or below both lengths: LayerNorm twice
    per encoder layer and three times per decoder layer (plus each stack's
    final norm when pre-norm), one flash forward per attention (encoder
    self, causal decoder self, decoder over the encoder's output) and its
    backward route."""
    from paddle_tpu_torch.kernels.flash_attention import backward_route
    out = {k: 0 for k in expected_launches(src, 1, d)}
    out["layer_norm"] = 2 * enc + 3 * dec + (2 if prenorm else 0)
    for n, tq, tk in ((enc, src, src), (dec, tgt, tgt), (dec, tgt, src)):
        out["flash_attention_fwd"] += n
        if backward_route(tq, tk, d) == "fused":
            out["flash_attention_bwd_fused"] += n
        else:
            out["flash_attention_bwd_dq"] += n
            out["flash_attention_bwd_dkv"] += n
    return out


def mt_model(torch, device: str, **over):
    from paddle_tpu_torch.models import Seq2SeqConfig, TransformerSeq2Seq
    return TransformerSeq2Seq(Seq2SeqConfig(**dict(MT_CFG, **over)),
                              device=device, seed=SEED)


def mt_grad_ms(torch, model, batch, gate: int) -> dict:
    """One forward and backward of ``model`` (no update) at the training
    flash gate ``gate``, after a warm-up: stream ms, peak allocated GB
    and the launches of the timed one."""
    from paddle_tpu_torch import kernels
    restore = flag_scope({"flash_attention_min_seq_train": gate})
    params = [p for p in model.parameters() if p.requires_grad]
    try:
        for _ in range(2):  # a warm-up, then the timed call
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
            loss = mt_loss(model(batch[0], batch[1]), batch[2])
            grads = torch.autograd.grad(loss, params)
            marks[1].record()
            marks[1].synchronize()
            del grads, loss
    finally:
        restore()
    return {"gate": gate, "ms": marks[0].elapsed_time(marks[1]),
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": nonzero(kernels.launch_counts())}


def mt_fit(torch, card: str) -> tuple:
    """(a) Transformer-base through ``Model.fit`` for MT_EPOCHS epochs of
    MT_STEPS captured steps, fed by an ``InMemoryDataset`` (MT_THREADS
    loader threads, ``local_shuffle(0)``) over slot files a
    ``DataGenerator`` wrote: Adam(beta1 0.9, beta2 0.98, eps 1e-9) over
    NoamDecay(512, 4000). Finite losses, the launches MT_EPOCHS x
    MT_STEPS times ``mt_launches``, the steady step's stream ms, tokens/s
    and peak memory; then one forward and backward at the phase's gate
    and at the default gate beside it (the yardstick). Returns (report,
    launch counts, the trained model, four sources)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.data import InMemoryDataset
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer.lr import NoamDecay
    t0 = time.perf_counter()
    files = mt_slot_files(torch, MT_DIR)
    write_s = time.perf_counter() - t0
    ds = InMemoryDataset()
    ds.set_slots([("src", "sparse", MT_SRC), ("tgt_in", "sparse", MT_TGT),
                  ("labels", "sparse", MT_TGT)])
    ds.set_batch_size(MT_BATCH)
    ds.set_thread(MT_THREADS)
    ds.set_filelist(files)
    t0 = time.perf_counter()
    loaded = ds.load_into_memory()
    ds.local_shuffle(0)
    load_s = time.perf_counter() - t0
    if loaded != MT_BATCH * MT_STEPS:
        raise AssertionError(f"mt: loaded {loaded} records")
    first = next(iter(ds))
    sources = first["src"][:MT_BEAM["sources"]].copy()
    if MT_DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    net = mt_model(torch, MT_DEVICE)
    model = Model(net, loss=mt_loss, optimizer=Adam(
        NoamDecay(d_model=MT_CFG["d_model"], warmup_steps=4000),
        beta1=0.9, beta2=0.98, epsilon=1e-9))
    rec = hapi_recorder(torch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(MTBatches(ds), epochs=MT_EPOCHS, callbacks=[rec], verbose=0)
    if MT_DEVICE == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [float(v) for v in rec.losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if MT_DEVICE == "cuda" else 0.0
    step_ms = steady_step_ms(rec.events, MT_STEPS)
    steps = MT_EPOCHS * MT_STEPS
    head = MT_CFG["d_model"] // MT_CFG["nhead"]
    per_step = mt_launches(MT_CFG["num_encoder_layers"],
                           MT_CFG["num_decoder_layers"], MT_SRC, MT_TGT,
                           head)
    step = model._train_step
    res = {"config": MT_CFG, "batch": MT_BATCH, "src_len": MT_SRC,
           "tgt_len": MT_TGT, "epochs": MT_EPOCHS, "steps": steps,
           "records": loaded, "loader_threads": MT_THREADS,
           "slot_files_write_s": write_s, "load_and_shuffle_s": load_s,
           "losses": losses, "fit_s": fit_s, "captures": step.captures,
           "step_ms": step_ms,
           "tokens_per_s": (MT_BATCH * (MT_SRC + MT_TGT) / step_ms * 1e3
                            if step_ms else None),
           "peak_allocated_gb": peak, "launches": nonzero(counts),
           "launches_per_step_expected": nonzero(per_step), "card": card}
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"mt fit: losses {losses}")
    if step.captures != 1:
        raise AssertionError(f"mt fit: {step.captures} captures (the fed "
                             f"batches changed the step's signature)")
    path_launches("mt_fit", counts, per_step, steps)
    log(f"mt fit [{card}]: {json.dumps(res)}")
    if MT_DEVICE == "cuda":
        batch = tuple(torch.from_numpy(a).to(MT_DEVICE) for a in
                      (first["src"], first["tgt_in"], first["labels"]))
        res["grad_at_gate"] = mt_grad_ms(torch, net, batch, MT_GATE)
        res["grad_at_default_gate"] = mt_grad_ms(torch, net, batch, 512)
        log(f"mt fwd+bwd at gate {MT_GATE}: "
            f"{json.dumps(res['grad_at_gate'])}; at the default gate 512 "
            f"(plain attention), the yardstick: "
            f"{json.dumps(res['grad_at_default_gate'])} [{card}]")
    del model, step
    return res, {"mt_fit": counts}, net, sources


def rel_gap(torch, got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    want = want.detach().double()
    return float((got.detach().cpu().double() - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


class ReluSigns:
    """The ReLU decisions of one forward, shared with another run of the
    same model: ``record`` (each layer's activation on the card) keeps
    every ``x > 0`` mask in call order, ``replay`` (on the CPU) applies
    the recorded mask, ``x * mask``, and counts the units whose own sign
    differs. A unit whose pre-activation lies within rounding of 0 takes
    either side of the kink on either device, and each such flip moves
    its ``linear1`` gradient column by a whole token's term (~1e-2 of the
    largest entry at these sizes: ``grad_max_rel_gap_own_relu``), so the
    gradients are compared with the kink decided alike. ReLU6 (``six``)
    has two edges: a unit within rounding of 0 or of 6 takes either side,
    so its masks are the middle and the clipped top."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.masks: list = []
        self.pos = 0
        self.flipped = 0
        self.units = 0

    @staticmethod
    def _decide(x, six: bool):
        if six:
            return (x >= 0) & (x <= 6), x > 6
        return x > 0, None

    def record(self, x, six: bool = False):
        mid, above = self._decide(x.detach(), six)
        self.masks.append((mid.cpu(), None if above is None
                           else above.cpu()))
        return self.torch.clamp(x, 0.0, 6.0) if six else self.torch.relu(x)

    def replay(self, x, six: bool = False):
        mid, above = self.masks[self.pos]
        self.pos += 1
        own, _ = self._decide(x.detach(), six)
        self.flipped += int((own.cpu() != mid).sum())
        self.units += mid.numel()
        out = x * mid.to(device=x.device, dtype=x.dtype)
        if above is not None:
            out = out + 6.0 * above.to(device=x.device, dtype=x.dtype)
        return out

    @staticmethod
    def install(model, fn) -> int:
        """Sets every layer's ReLU activation to ``fn``; returns how many
        layers took it."""
        n = 0
        for mod in model.modules():
            if getattr(mod, "activation", None) is not None:
                mod.activation = fn
                n += 1
        return n

    def install_children(self, model, how) -> list:
        """Replaces every ReLU/ReLU6 child module with ``how(x, six)``;
        returns what ``restore`` puts back."""
        from paddle_tpu_torch.nn import ReLU, ReLU6
        old = []
        for mod in model.modules():
            for name, child in list(mod.named_children()):
                if isinstance(child, (ReLU, ReLU6)):
                    six = isinstance(child, ReLU6)
                    old.append((mod, name, child))
                    setattr(mod, name, call_module(
                        self.torch, lambda x, s=six: how(x, s)))
        return old

    @staticmethod
    def restore(old: list) -> None:
        for mod, name, child in old:
            setattr(mod, name, child)


def grads_card_cpu(torch, card, cpu, run, tag: str) -> dict:
    """One forward and backward of ``run(model, device)`` (a scalar loss)
    on the card and on the CPU from the same weights, the CPU's ReLUs
    deciding as the card's did (``ReluSigns``): the loss's relative gap
    and each gradient's largest gap over its leaf's largest CPU entry
    (``grad_gaps``), both within GRAD_REL_TOL; the card's launches, the
    CPU's (all 0); the ReLU units that flipped, and the CPU's own-ReLU
    gradient gap beside them (reported, not bounded)."""
    from paddle_tpu_torch import kernels
    signs = ReluSigns(torch)
    layers = signs.install(card, signs.record)
    out, counts = {}, {}

    def side(model, dev):
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        t0 = time.perf_counter()
        loss = run(model, dev)
        grads = torch.autograd.grad(loss, [dict(model.named_parameters())[n]
                                           for n in names])
        return (float(loss.detach()), dict(zip(names, grads)),
                time.perf_counter() - t0)

    for name, dev, model in (("card", MT_DEVICE, card), ("cpu", "cpu", cpu)):
        if name == "cpu":
            signs.install(cpu, signs.replay)
        kernels.reset_launch_counts()
        out[name] = side(model, dev)
        counts[name] = kernels.launch_counts()
    signs.install(cpu, torch.relu)
    own = side(cpu, "cpu")
    rel = grad_gaps(torch, out["card"][1], out["cpu"][1])
    rel_own = grad_gaps(torch, out["card"][1], own[1])
    worst = max(rel, key=rel.get)
    res = {"loss_card": out["card"][0], "loss_cpu": out["cpu"][0],
           "loss_rel_diff": abs(out["card"][0] - out["cpu"][0])
           / abs(out["cpu"][0]),
           "grad_max_rel_gap": rel[worst], "worst_grad": worst,
           "grads_compared": len(rel), "relu_layers": layers,
           "relu_units": signs.units, "relu_units_flipped": signs.flipped,
           "grad_max_rel_gap_own_relu": max(rel_own.values()),
           "worst_grad_own_relu": max(rel_own, key=rel_own.get),
           "cpu_s": out["cpu"][2], "launches_card": nonzero(counts["card"]),
           "launches_cpu": nonzero(counts["cpu"])}
    log(f"{tag}: {json.dumps(res)}")
    if not (res["loss_rel_diff"] <= GRAD_REL_TOL
            and res["grad_max_rel_gap"] <= GRAD_REL_TOL):
        raise AssertionError(f"{tag}: card and CPU disagree: {res} "
                             f"(tolerance {GRAD_REL_TOL} relative)")
    if res["launches_cpu"]:
        raise AssertionError(f"{tag}: the CPU side launched {counts['cpu']}")
    return res, counts["card"]


def mt_card_against_cpu(torch) -> dict:
    """(b) The translation model at MT_CPU_LAYERS + MT_CPU_LAYERS layers,
    full width, dropout 0, seed SEED: one forward and backward of a
    MT_CPU_BATCH batch on the card (kernels) and on the CPU (plain
    versions) from the same weights; the loss and every gradient within
    GRAD_REL_TOL relative, the card's launches exactly ``mt_launches``."""
    over = dict(num_encoder_layers=MT_CPU_LAYERS,
                num_decoder_layers=MT_CPU_LAYERS, dropout=0.0)
    card = mt_model(torch, MT_DEVICE, **over)
    cpu = mt_model(torch, "cpu", **over)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    src, tgt_in, labels = mt_records(MT_CPU_BATCH, SEED + 21)

    def run(model, dev):
        a, b, c = (torch.from_numpy(x).to(dev) for x in (src, tgt_in, labels))
        return mt_loss(model(a, b), c)

    res, counts = grads_card_cpu(torch, card, cpu, run, "mt card vs cpu")
    res["host"] = cpu_facts(torch)
    want = mt_launches(MT_CPU_LAYERS, MT_CPU_LAYERS, MT_SRC, MT_TGT,
                       MT_CFG["d_model"] // MT_CFG["nhead"])
    if counts != want:
        raise AssertionError(f"mt card vs cpu launches {counts} != {want}")
    return res


class BeamChoices:
    """The beam decisions of one decode, shared with another run of the
    same model, as ``ReluSigns`` shares the ReLU decisions. ``record``
    (the card's ``beam_search_step``) keeps each step's chosen candidates
    and the gap between the k-th and the (k+1)-th best total. ``replay``
    (the CPU's) ranks its own totals, then takes the recorded candidates
    at the CPU's own totals. A row of a step flips where the CPU's own
    choice differs from the card's; its margin is the CPU's k-th best
    total less the smallest CPU total among the card's choices (0 where
    both chose the same set in another order). A barely trained model
    spreads its 37000 log-probabilities over a few thousand ulps, so
    candidates within rounding of a tie are common and rank either way
    on either device, and one flip changes every later step: the decodes
    are compared with the choices made alike, each flip's margin
    bounded."""

    def __init__(self, torch, step_fn) -> None:
        self.torch = torch
        self.step_fn = step_fn
        self.chosen: list = []
        self.gaps: list = []
        self.pos = 0
        self.flipped = 0
        self.margin = 0.0

    @staticmethod
    def totals(torch, log_probs, scores, fin, end):
        """``beam_search_step``'s candidate totals ``[batch, beam *
        vocab]`` (a finished beam proposes only ``end``, at its score)."""
        from paddle_tpu_torch.ops.beam import _NEG_INF
        fin_row = torch.full(log_probs.shape[-1:], _NEG_INF,
                             dtype=log_probs.dtype, device=log_probs.device)
        fin_row[end] = 0.0
        step = torch.where(fin[:, :, None], fin_row[None, None, :], log_probs)
        return (scores[:, :, None] + step).reshape(log_probs.shape[0], -1)

    def record(self, log_probs, scores, fin, k, end):
        torch = self.torch
        total = self.totals(torch, log_probs, scores, fin, end)
        top = torch.sort(total, dim=-1, descending=True).values[:, :k + 1]
        self.gaps.append((top[:, k - 1] - top[:, k]).min())
        out = self.step_fn(log_probs, scores, fin, k, end)
        self.chosen.append((out[1].long() * log_probs.shape[-1]
                            + out[0].long()).cpu())
        return out

    def replay(self, log_probs, scores, fin, k, end):
        torch = self.torch
        vocab = log_probs.shape[-1]
        total = self.totals(torch, log_probs, scores, fin, end)
        own_token, own_parent, own_scores, _ = self.step_fn(
            log_probs, scores, fin, k, end)
        idx = self.chosen[self.pos].to(total.device)
        self.pos += 1
        taken = torch.gather(total, 1, idx)
        rows = (own_parent.long() * vocab + own_token.long() != idx).any(-1)
        if bool(rows.any()):
            self.flipped += int(rows.sum())
            margin = own_scores[:, k - 1] - taken.min(-1).values
            self.margin = max(self.margin, float(margin[rows].max()))
        parent = torch.div(idx, vocab, rounding_mode="floor")
        token = (idx % vocab).to(torch.int32)
        finished = torch.gather(fin, 1, parent) | (token == end)
        return token, parent.to(torch.int32), taken, finished


def same_hypotheses(seq_a, score_a, seq_b, score_b) -> tuple:
    """Whether each row of ``seq_a`` (``[batch, beam, len]``) holds the
    sequences of the same row of ``seq_b`` in any beam order; the largest
    gap between one sequence's two scores; how many beams stand in
    another slot (the final sort of near-equal scores)."""
    gap, moved = 0.0, 0
    for b in range(seq_a.shape[0]):
        for j in range(seq_a.shape[1]):
            hit = (seq_b[b] == seq_a[b, j]).all(-1).nonzero()
            if hit.numel() == 0:
                return False, float("inf"), moved
            i = int(hit[0, 0])
            moved += int(i != j)
            gap = max(gap, float((score_a[b, j] - score_b[b, i]).abs()))
    return True, gap, moved


def mt_beam(torch, model, sources) -> dict:
    """(c) ``decode_beam`` of the trained model (eval) on the card and of
    a CPU copy of it whose beams choose as the card's did
    (``BeamChoices``): the same hypotheses in each row, their scores
    within MT_BEAM_SCORE_TOL, and each flipped choice within
    MT_BEAM_SCORE_TOL of the CPU's own. The flips, their largest margin
    and the smallest gap between the k-th and (k+1)-th candidate of any
    step on the card (how near a tie the run came) are reported."""
    from paddle_tpu_torch.ops import beam as beam_ops
    cfg = dict(MT_BEAM)
    n = cfg.pop("sources")
    model.eval()
    cpu = mt_model(torch, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    step_fn = beam_ops.beam_search_step
    choices = BeamChoices(torch, step_fn)
    src = torch.from_numpy(sources[:n])
    out = {}
    for side, dev, m, fn in (("card", MT_DEVICE, model, choices.record),
                             ("cpu", "cpu", cpu, choices.replay)):
        t0 = time.perf_counter()
        beam_ops.beam_search_step = fn
        try:
            seqs, scores = m.decode_beam(src.to(dev), **cfg)
        finally:
            beam_ops.beam_search_step = step_fn
        out[side] = (seqs.cpu(), scores.cpu(), time.perf_counter() - t0)
    seq_card, score_card, card_s = out["card"]
    seq_cpu, score_cpu, cpu_s = out["cpu"]
    same, gap, moved = same_hypotheses(seq_card, score_card, seq_cpu,
                                       score_cpu)
    res = {**MT_BEAM, "same_hypotheses": same,
           "sequences_equal": bool(torch.equal(seq_card, seq_cpu)),
           "beams_in_another_slot": moved, "score_max_abs_diff": gap,
           "choices_flipped": choices.flipped,
           "choices": choices.pos * seq_card.shape[0],
           "flip_max_margin": choices.margin,
           "min_topk_gap_card": float(torch.stack(choices.gaps).min()),
           "card_s": card_s, "cpu_s": cpu_s,
           "best": seq_card[0, 0, :12].tolist(),
           "scores": score_card[:, 0].tolist()}
    log(f"mt beam: {json.dumps(res)}")
    if not same or gap > MT_BEAM_SCORE_TOL \
            or choices.margin > MT_BEAM_SCORE_TOL:
        raise AssertionError(f"mt beam: card and CPU disagree: {res}")
    return res


def remat_batches(torch, vocab: int) -> list:
    """REMAT_STEPS pretraining batches (RESUME_BATCH x RESUME_SEQ, the
    JAX bench's masking) made on the card beforehand."""
    samples = PretrainSamples(RESUME_BATCH * REMAT_STEPS, RESUME_SEQ,
                              vocab, SEED + 70)
    batches = []
    for k in range(REMAT_STEPS):
        rows = [samples[i] for i in range(k * RESUME_BATCH,
                                          (k + 1) * RESUME_BATCH)]
        batches.append(tuple(torch.from_numpy(np.stack(col)).to(MT_DEVICE)
                             for col in zip(*rows)))
    return batches


def remat_bert(torch, card: str) -> tuple:
    """(d) ``transformer_remat`` on BERT-base: phase 5c's bf16 model with
    the fused flags over the flat fused state, b8 x s512, dropout 0.1,
    REMAT_STEPS captured steps from one seed and batches, remat off and
    then on: the losses and every leaf of the training state (parameters,
    fp32 masters, moments, step counter, generator) equal bit for bit;
    the recompute adds 2 LayerNorms and a flash forward per layer a step.
    Peak allocated memory and the replays' stream ms of both."""
    from paddle_tpu_torch import kernels
    batches = None
    runs, counts = {}, {}
    for remat in (False, True):
        name = "remat_on" if remat else "remat_off"
        restore = flag_scope(dict(FUSED_FLAGS, transformer_remat=remat))
        try:
            torch.cuda.empty_cache()
            model = resume_model(torch, 12, "bfloat16")
            cfg = model.config
            if batches is None:
                batches = remat_batches(torch, cfg.vocab_size)
            torch.cuda.reset_peak_memory_stats()
            step = make_train_step(model, fused_state=True, compiled=True)
            kernels.reset_launch_counts()
            losses, ms = [], []
            for b in batches:
                loss, t = timed_step(torch, step, b)
                losses.append(loss)
                ms.append(t)
            counts[name] = kernels.launch_counts()
            runs[name] = {"losses": losses, "step_ms": ms,
                          "replay_ms": float(np.median(ms[1:])),
                          "peak_allocated_gb":
                              torch.cuda.max_memory_allocated() / 2 ** 30,
                          "captures": step.captures,
                          "state": state_on_host(step)}
            del step, model
        finally:
            restore()
    torch.cuda.empty_cache()
    differ = equal_states(torch, runs["remat_off"].pop("state"),
                          runs["remat_on"].pop("state"))
    per_step = expected_launches(RESUME_SEQ, cfg.num_hidden_layers,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 FUSED_FLAGS,
                                 rows=RESUME_BATCH * RESUME_MASKED,
                                 vocab=cfg.vocab_size)
    recomputed = dict(per_step)
    recomputed["layer_norm"] += 2 * cfg.num_hidden_layers
    recomputed["flash_attention_fwd"] += cfg.num_hidden_layers
    res = {**runs, "state_leaves_differing": differ,
           "peak_gb_saved": runs["remat_off"]["peak_allocated_gb"]
           - runs["remat_on"]["peak_allocated_gb"],
           "per_step_launches_remat": nonzero(recomputed), "card": card}
    log(f"remat [{card}]: {json.dumps(res)}")
    if runs["remat_off"]["losses"] != runs["remat_on"]["losses"] or differ \
            or not all(np.isfinite(runs["remat_on"]["losses"])):
        raise AssertionError(f"remat changed the run: {res}")
    path_launches("remat_off", counts["remat_off"], per_step, REMAT_STEPS)
    path_launches("remat_on", counts["remat_on"], recomputed, REMAT_STEPS)
    return res, counts


def prenorm_transformer(torch) -> tuple:
    """(e) ``nn.Transformer(normalize_before=True)`` at the reference
    defaults (d 512, 8 heads, 6 + 6, FFN 2048), dropout 0, src MT_SRC /
    tgt MT_TGT, batch PRENORM_BATCH: one forward and backward of
    ``sum(out * w)`` on the card against the CPU within GRAD_REL_TOL
    (launches: ``mt_launches`` with both final norms); then one
    ``need_weights=True`` attention call (plain composition) on the card
    against the CPU, its output and weights within GRAD_REL_TOL."""
    from paddle_tpu_torch import nn as pnn
    gen = torch.Generator(device=MT_DEVICE).manual_seed(SEED)
    kw = dict(PRENORM_CFG, normalize_before=True, dropout=0.0)
    card = pnn.Transformer(**kw, device=MT_DEVICE, generator=gen)
    cpu = pnn.Transformer(**kw, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(SEED + 31)
    d, heads = PRENORM_CFG["d_model"], PRENORM_CFG["nhead"]
    src, tgt, w = (rng.standard_normal(s).astype(np.float32) for s in
                   ((PRENORM_BATCH, MT_SRC, d), (PRENORM_BATCH, MT_TGT, d),
                    (PRENORM_BATCH, MT_TGT, d)))

    def run(model, dev):
        a, b, c = (torch.from_numpy(x).to(dev) for x in (src, tgt, w))
        return (model(a, b) * c).sum()

    res, counts = grads_card_cpu(torch, card, cpu, run,
                                 "prenorm transformer card vs cpu")
    want = mt_launches(PRENORM_CFG["num_encoder_layers"],
                       PRENORM_CFG["num_decoder_layers"], MT_SRC, MT_TGT,
                       d // heads, prenorm=True)
    if counts != want:
        raise AssertionError(f"prenorm launches {counts} != {want}")
    attn = pnn.MultiHeadAttention(d, heads, need_weights=True,
                                  device=MT_DEVICE, generator=gen)
    attn_cpu = pnn.MultiHeadAttention(d, heads, need_weights=True,
                                      device="cpu")
    attn_cpu.load_state_dict({k: v.cpu()
                              for k, v in attn.state_dict().items()})
    outs = {}
    with torch.no_grad():
        for dev, m in ((MT_DEVICE, attn), ("cpu", attn_cpu)):
            outs[dev] = m(torch.from_numpy(tgt).to(dev),
                          torch.from_numpy(src).to(dev))
    res["need_weights"] = {
        "out_rel_gap": rel_gap(torch, outs[MT_DEVICE][0], outs["cpu"][0]),
        "weights_rel_gap": rel_gap(torch, outs[MT_DEVICE][1],
                                   outs["cpu"][1]),
        "weights_shape": list(outs["cpu"][1].shape)}
    log(f"need_weights card vs cpu: {json.dumps(res['need_weights'])}")
    if max(res["need_weights"]["out_rel_gap"],
           res["need_weights"]["weights_rel_gap"]) > GRAD_REL_TOL:
        raise AssertionError(f"need_weights: card and CPU disagree: "
                             f"{res['need_weights']}")
    return res, {"prenorm": counts}


def run_mt(torch) -> tuple:
    """Phase 11. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    restore = flag_scope({"flash_attention_min_seq_train": MT_GATE})
    try:
        report["mt_fit"], c, model, sources = mt_fit(torch, card)
        counts.update(c)
        report["mt_beam"] = mt_beam(torch, model, sources)
        del model
        torch.cuda.empty_cache()
        report["mt_card_vs_cpu"] = mt_card_against_cpu(torch)
        report["prenorm"], c = prenorm_transformer(torch)
        counts.update(c)
    finally:
        restore()
        shutil.rmtree(MT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    report["remat"], c = remat_bert(torch, card)
    counts.update(c)
    report["mt_phase_s"] = time.perf_counter() - t_phase
    log(f"translation phase: {report['mt_phase_s']:.1f} s [{card}]")
    return report, counts


# ---------------------------------------------------------------------------
# phase 12: ResNet-50 image classification (A16) with the rest of the
# optimizers and their wrappers
# ---------------------------------------------------------------------------

# (a) ResNet-50 as the JAX bench builds it (bench.py:591-617): bf16, NHWC,
# 224 x 224, 1000 classes, Momentum(0.1, 0.9), cross_entropy, b128, fed
# through Model.fit from RN_WORKERS worker processes for RN_EPOCHS epochs
# of RN_STEPS steps
RN_DEVICE = "cuda"
RN_BATCH, RN_HW, RN_CLASSES = 128, 224, 1000
RN_EPOCHS, RN_STEPS, RN_WORKERS = 2, 4, 2
# (b) LarsMomentum's captured steps; (d) remat's
RN_LARS_STEPS, RN_REMAT_STEPS = 4, 3
# (c), (f), (g): ResNet(BottleneckBlock, [1, 1, 1, 1]) at full channel
# widths, fp32, RN_SMALL_HW x RN_SMALL_HW images, batch RN_SMALL_BATCH
RN_SMALL_HW, RN_SMALL_BATCH = 64, 8
# (c): card against CPU. cuDNN's fp32 convolutions (TF32 off) against the
# CPU's, weight gradients summing up to 8192 products each, then
# BatchNorm's batch statistics: the loss and each gradient within this
# share of the leaf's largest entry, with the ReLU and max-pool decisions
# shared (RnSigns)
RN_GRAD_TOL = 1e-4
# (e): the JAX package's own tolerance for the s2d stem
# (tests/test_model_zoo_extra.py:550)
RN_S2D_TOL = 2e-5
# (g): updates on ResNet-50's own leaves, card against CPU (TOL); then
# the captured TrainStep against the eager one
RN_SWEEP_STEPS = 3
# (h): Model.fit interrupted at RN_SAVE_AT and resumed, at b32
RN_RESUME_BATCH, RN_SAVE_AT = 32, 4
RN_DIR = "chip_smoke_rn"  # the checkpoints of (h) (removed after it)
# the ResNet paths run no kernel of the port (cuDNN's convolutions, plain
# PyTorch around them): their launch counts must stay 0
PATH_KERNELS.update({"rn_fit": ()})


class ImageSamples:
    """``n`` NHWC images (standard normal from numpy's ``seed``, then cast
    to ``dtype`` as torch tensors: the bench's bf16 inputs) and their
    int64 class labels; a map-style dataset whose samples collate into
    ``(images, labels)``."""

    def __init__(self, torch, n: int, hw: int, seed: int,
                 dtype="bfloat16") -> None:
        rng = np.random.default_rng(seed)
        self.images = torch.from_numpy(rng.standard_normal(
            (n, hw, hw, 3), dtype=np.float32)).to(getattr(torch, dtype))
        self.labels = rng.integers(0, RN_CLASSES, n).astype(np.int64)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]

    def __len__(self):
        return len(self.labels)


def rn_loss(out, label):
    from paddle_tpu_torch.ops.loss import cross_entropy
    return cross_entropy(out, label)


def rn_loader(torch, ds, batch: int):
    """Seeded-shuffle batches of ``ds`` from RN_WORKERS worker processes
    (the images cross through shared memory)."""
    from paddle_tpu_torch.data import BatchSampler, DataLoader, RandomSampler
    return DataLoader(ds, batch_sampler=BatchSampler(
        RandomSampler(ds, seed=SEED), batch_size=batch, drop_last=True),
        num_workers=RN_WORKERS, timeout=120.0)


def rn_batches(torch, ds, batch: int, n: int) -> list:
    """The first ``n`` batches of ``ds`` in order, on the card."""
    return [(ds.images[i * batch:(i + 1) * batch].to(RN_DEVICE),
             torch.from_numpy(ds.labels[i * batch:(i + 1) * batch]).to(
                 RN_DEVICE)) for i in range(n)]


def rn50(torch, dtype: str = "bfloat16"):
    """ResNet-50 NHWC from SEED on RN_DEVICE, cast as the JAX bench casts
    it."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import resnet50
    net = resnet50(data_format="NHWC", device=RN_DEVICE, seed=SEED)
    return cast_model_to_low_precision(net, dtype) \
        if dtype != "float32" else net


def rn_small(torch, device: Optional[str] = None, dtype: str = "float32"):
    """ResNet(BottleneckBlock, [1, 1, 1, 1]) at full channel widths, NHWC,
    from SEED, on ``device`` (RN_DEVICE by default)."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import BottleneckBlock, ResNet
    net = ResNet(BottleneckBlock, [1, 1, 1, 1], RN_CLASSES,
                 data_format="NHWC", device=device or RN_DEVICE, seed=SEED)
    return cast_model_to_low_precision(net, dtype) \
        if dtype != "float32" else net


def rn_macs(torch, net, hw: int) -> int:
    """Multiply-adds of one image's forward: each conv's ``Cout Ho Wo x
    Cin/groups kh kw`` and the classifier's, from the output shapes of a
    no-grad forward (its BatchNorm statistics put back after)."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    saved = {n: b.clone() for n, b in net.named_buffers()}
    macs = [0]

    def hook(mod, _inp, out):
        w = mod.weight
        if isinstance(mod, Conv2D):
            macs[0] += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        else:
            macs[0] += out.numel() * w.shape[0]

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (Conv2D, Linear))]
    try:
        with torch.no_grad():
            net(torch.zeros((1, hw, hw, 3), dtype=net.conv1.weight.dtype,
                            device=net.conv1.weight.device))
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for n, b in net.named_buffers():
                b.copy_(saved[n])
    return macs[0]


def rn_timed_steps(torch, step, batches) -> tuple:
    """``step`` over ``batches``: each loss (synchronised at the end) and
    each step's stream ms (events around it)."""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(batches) + 1)]
    marks[0].record()
    losses = []
    for k, (x, y) in enumerate(batches):
        losses.append(step(x, labels=(y,))["loss"])
        marks[k + 1].record()
    marks[-1].synchronize()
    return ([float(v) for v in losses],
            [marks[k].elapsed_time(marks[k + 1])
             for k in range(len(batches))])


def rn_busy(torch, step, batch, steps: int = 2) -> dict:
    """torch.profiler over ``steps`` replays: the device ms a step, the
    wall ms and the device's busy share of it, the largest rows."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch[0], labels=(batch[1],))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_rows(prof, steps)
    device_ms = sum(r[0] for r in rows) if rows else None
    # PyTorch's own elementwise and reduction kernels (BatchNorm's
    # composition, ReLU, the pools, the optimizer, casts) against the
    # libraries' (cuDNN's convolutions, cuBLAS's classifier)
    native = [r for r in rows if "at::native" in r[2]]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "pytorch_native_ms": sum(r[0] for r in native),
            "pytorch_native_launches": sum(r[1] for r in native),
            "library_ms": sum(r[0] for r in rows if r not in native),
            "library_launches": sum(r[1] for r in rows if r not in native),
            "top_ms_launches_name": rows[:12],
            "top_library_ms_launches_name": [r for r in rows
                                             if r not in native][:8]}


def rn_fit(torch, card: str) -> tuple:
    """(a) ResNet-50 bf16 NHWC b128 through ``Model.fit`` (Momentum(0.1,
    0.9), cross_entropy) for RN_EPOCHS epochs of RN_STEPS captured steps
    from RN_WORKERS workers: finite losses, one capture, every BatchNorm
    buffer moved and finite and fp32, no kernel of the port launched;
    images/s (median stream ms of steps 2..RN_STEPS of each epoch), peak
    memory, the busy share of two profiled replays after, the FLOPs
    (2 x MACs of the forward, 3 x that a training step). Returns (report,
    counts, the net's parameter shapes)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Momentum
    t0 = time.perf_counter()
    ds = ImageSamples(torch, RN_BATCH * RN_STEPS, RN_HW, SEED + 200)
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = rn50(torch)
    macs = rn_macs(torch, net, RN_HW)
    before = host_copy(dict(net.named_buffers()))
    model = Model(net, loss=rn_loss, optimizer=Momentum(0.1, 0.9))
    rec = hapi_recorder(torch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(rn_loader(torch, ds, RN_BATCH), epochs=RN_EPOCHS,
              callbacks=[rec], verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in rec.losses]
    step_ms = steady_step_ms(rec.events, RN_STEPS)
    after = host_copy(dict(net.named_buffers()))
    unmoved = [n for n in after if torch.equal(after[n], before[n])]
    bad = [n for n, b in after.items() if b.dtype != torch.float32
           or not bool(torch.isfinite(b).all())]
    step = model._train_step
    captures = step.captures
    busy = rn_busy(torch, step, rn_batches(torch, ds, RN_BATCH, 1)[0])
    flops_step = 3 * 2 * macs * RN_BATCH
    res = {"model": "resnet50", "dtype": "bfloat16", "layout": "NHWC",
           "image": RN_HW, "batch": RN_BATCH, "epochs": RN_EPOCHS,
           "steps": RN_EPOCHS * RN_STEPS, "workers": RN_WORKERS,
           "optimizer": "Momentum(0.1, 0.9)", "losses": losses,
           "captures": captures, "capture_ms": step.capture_ms,
           "captures_after_profiled_replays": step.captures,
           "step_ms": step_ms,
           "images_per_s": RN_BATCH / step_ms * 1e3 if step_ms else None,
           "peak_allocated_gb": peak, "fit_s": fit_s, "data_s": data_s,
           "forward_macs_per_image": macs,
           "forward_flops_per_image_2x_macs": 2 * macs,
           "train_flops_per_step_3x_forward": flops_step,
           "achieved_tflops": flops_step / (step_ms / 1e3) / 1e12
           if step_ms else None,
           "bn_buffers": len(after), "bn_buffers_unmoved": unmoved,
           "bn_buffers_bad": bad, "launches": nonzero(counts),
           "profiled_replays": busy, "card": card}
    log(f"resnet50 fit [{card}]: {json.dumps(res)}")
    if len(losses) != RN_EPOCHS * RN_STEPS or not all(np.isfinite(losses)) \
            or captures != 1 or step.captures != 1 or unmoved or bad \
            or nonzero(counts):
        raise AssertionError(f"resnet50 fit: {res}")
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    del model, step, net
    return res, {"rn_fit": counts}, shapes, ds


def rn_lars(torch, ds, card: str) -> dict:
    """(b) The same model and batch under LarsMomentum(0.1, 0.9,
    lars_coeff=0.001, lars_weight_decay=5e-4): RN_LARS_STEPS captured
    steps, finite losses, one capture; images/s from the replays."""
    from paddle_tpu_torch.optimizer import LarsMomentum
    from paddle_tpu_torch.static import TrainStep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = TrainStep(rn50(torch), LarsMomentum(
        0.1, 0.9, lars_coeff=0.001, lars_weight_decay=5e-4), rn_loss,
        seed=SEED)
    batches = rn_batches(torch, ds, RN_BATCH, RN_LARS_STEPS)
    losses, ms = rn_timed_steps(torch, step, batches)
    replay = float(np.median(ms[1:]))
    res = {"optimizer": "LarsMomentum(0.1, 0.9, lars_coeff=0.001, "
                        "lars_weight_decay=5e-4)", "losses": losses,
           "step_ms": ms, "replay_ms": replay,
           "images_per_s": RN_BATCH / replay * 1e3,
           "captures": step.captures,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "card": card}
    log(f"resnet50 lars [{card}]: {json.dumps(res)}")
    if not all(np.isfinite(losses)) or step.captures != 1:
        raise AssertionError(f"resnet50 lars: {res}")
    return res


def call_module(torch, fn):
    """A module whose forward is ``fn`` (a ReLU or max pool replaced for
    a card-against-CPU run)."""
    class Call(torch.nn.Module):
        def forward(self, x):
            return fn(x)
    return Call()


class RnSigns:
    """ReluSigns for the ResNet: the ReLU decisions (``relu`` of the model
    and of every block, in call order) and the stem max pool's choice in
    each window (its argmax), recorded on the card and replayed on the
    CPU, where a unit within rounding of 0, or a window whose two largest
    entries lie within rounding, would otherwise decide the other way;
    the flips are counted."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.relu = ReluSigns(torch)
        self.pools: list = []
        self.pos = 0
        self.pool_flips = 0
        self.windows = 0

    def _pool(self, x):
        F = self.torch.nn.functional
        xc = x.permute(0, 3, 1, 2)
        return F.max_pool2d(xc, 3, 2, 1, return_indices=True), xc

    def pool_record(self, x):
        (out, idx), _ = self._pool(x)
        self.pools.append(idx.detach().cpu())
        return out.permute(0, 2, 3, 1)

    def pool_replay(self, x):
        (own, own_idx), xc = self._pool(x)
        idx = self.pools[self.pos].to(x.device)
        self.pos += 1
        self.pool_flips += int((own_idx != idx).sum())
        self.windows += idx.numel()
        out = xc.flatten(2).gather(2, idx.flatten(2)).view_as(own)
        return out.permute(0, 2, 3, 1)

    def install(self, model, relu_fn, pool_fn) -> dict:
        """Sets ``relu_fn`` in place of every ``relu`` and ``pool_fn`` of
        the stem pool; returns the modules replaced, to restore."""
        torch = self.torch
        old = {}
        for mod in model.modules():
            if isinstance(getattr(mod, "relu", None), torch.nn.Module):
                old[(mod, "relu")] = mod.relu
                mod.relu = call_module(torch, relu_fn)
        old[(model, "maxpool")] = model.maxpool
        model.maxpool = call_module(torch, pool_fn)
        return old

    @staticmethod
    def restore(old: dict) -> None:
        for (mod, name), m in old.items():
            setattr(mod, name, m)


def rn_card_against_cpu(torch, card: str) -> dict:
    """(c) The small ResNet, fp32 (TF32 off), RN_SMALL_BATCH images of
    RN_SMALL_HW: one training-mode forward and backward on the card and
    on the CPU from the same weights and buffers, the CPU deciding each
    ReLU and max-pool window as the card did (``RnSigns``), under the
    two-pass statistics and under the default single pass. Two-pass: the
    loss, every gradient and every updated BatchNorm buffer within
    RN_GRAD_TOL of its leaf's largest entry. Single pass: the loss and
    the buffers within RN_GRAD_TOL; its gradients are reported, not
    bounded: ``E[x^2] - E[x]^2`` in fp32 cancels where a channel's spread
    is small against its mean, and its gradient there is rounding (the
    JAX package's own fp32 gradient strays as far from float64). Each
    side's gap to a float64 two-pass CPU run, the flips, and the gap
    with the CPU's own decisions are reported."""
    cardm = rn_small(torch, RN_DEVICE)
    cpum = rn_small(torch, "cpu")
    cpum.load_state_dict({k: v.cpu() for k, v in cardm.state_dict().items()})
    start = {k: v.clone() for k, v in cpum.named_buffers()}
    rng = np.random.default_rng(SEED + 210)
    x = rng.standard_normal((RN_SMALL_BATCH, RN_SMALL_HW, RN_SMALL_HW, 3),
                            dtype=np.float32)
    y = rng.integers(0, RN_CLASSES, RN_SMALL_BATCH).astype(np.int64)

    def side(model, dev, dtype=torch.float32):
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(start[k])
        names = [n for n, _ in model.named_parameters()]
        loss = rn_loss(model(torch.from_numpy(x).to(dev, dtype)),
                       torch.from_numpy(y).to(dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return (float(loss.detach()), dict(zip(names, grads)),
                {k: b.detach().clone() for k, b in model.named_buffers()})

    def pair(single: bool) -> tuple:
        restore = flag_scope({"batch_norm_single_pass": single})
        try:
            signs = RnSigns(torch)
            old = signs.install(cardm, signs.relu.record, signs.pool_record)
            card_out = side(cardm, RN_DEVICE)
            RnSigns.restore(old)
            old = signs.install(cpum, signs.relu.replay, signs.pool_replay)
            cpu_out = side(cpum, "cpu")
            RnSigns.restore(old)
            own = side(cpum, "cpu")
        finally:
            restore()
        return signs, card_out, cpu_out, own

    runs = {"two_pass": pair(False), "single_pass": pair(True)}
    cpum.double()
    restore = flag_scope({"batch_norm_single_pass": False})
    try:
        f64 = side(cpum, "cpu", torch.float64)
    finally:
        restore()
    res = {"batch": RN_SMALL_BATCH, "image": RN_SMALL_HW,
           "tolerance": RN_GRAD_TOL, "host": cpu_facts(torch), "card": card}
    for name, (signs, card_out, cpu_out, own) in runs.items():
        gaps = grad_gaps(torch, card_out[1], cpu_out[1])
        bufs = grad_gaps(torch, card_out[2], cpu_out[2])
        worst, worst_buf = max(gaps, key=gaps.get), max(bufs, key=bufs.get)
        res[name] = {
            "loss_card": card_out[0], "loss_cpu": cpu_out[0],
            "loss_rel_diff": abs(card_out[0] - cpu_out[0])
            / abs(cpu_out[0]),
            "grad_max_rel_gap": gaps[worst], "worst_grad": worst,
            "grads_compared": len(gaps),
            "buffer_max_rel_gap": bufs[worst_buf], "worst_buffer": worst_buf,
            "buffers_compared": len(bufs),
            "relu_units": signs.relu.units,
            "relu_units_flipped": signs.relu.flipped,
            "pool_windows": signs.windows,
            "pool_windows_flipped": signs.pool_flips,
            "grad_max_rel_gap_own_decisions": max(grad_gaps(
                torch, card_out[1], own[1]).values()),
            "card_grad_gap_to_float64": max(grad_gaps(
                torch, card_out[1], f64[1]).values()),
            "cpu_grad_gap_to_float64": max(grad_gaps(
                torch, own[1], f64[1]).values())}
    log(f"resnet card vs cpu: {json.dumps(res)}")
    two, one = res["two_pass"], res["single_pass"]
    if max(two["loss_rel_diff"], two["grad_max_rel_gap"],
           two["buffer_max_rel_gap"], one["loss_rel_diff"],
           one["buffer_max_rel_gap"]) > RN_GRAD_TOL:
        raise AssertionError(f"resnet card vs cpu: {res}")
    return res


def rn_remat(torch, ds, card: str) -> dict:
    """(d) ``resnet_block_remat`` on ResNet-50 bf16 b128, RN_REMAT_STEPS
    captured Momentum steps from one seed and batches, with
    ``deterministic`` on: remat off and on equal bit for bit (losses,
    parameters, fp32 masters, velocities, step counter, every BatchNorm
    buffer: the recompute moves none); a third run with ``deterministic``
    off times what determinism costs. Peak memory and replay ms of
    each."""
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import TrainStep
    batches = rn_batches(torch, ds, RN_BATCH, RN_REMAT_STEPS)
    runs, states = {}, {}
    for name, flags in (("remat_off", dict(resnet_block_remat=False,
                                           deterministic=True)),
                        ("remat_on", dict(resnet_block_remat=True,
                                          deterministic=True)),
                        ("nondeterministic", dict(resnet_block_remat=False,
                                                  deterministic=False))):
        restore = flag_scope(flags)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = TrainStep(rn50(torch), Momentum(0.1, 0.9), rn_loss,
                             seed=SEED)
            losses, ms = rn_timed_steps(torch, step, batches)
            runs[name] = {"losses": losses, "step_ms": ms,
                          "replay_ms": float(np.median(ms[1:])),
                          "peak_allocated_gb":
                              torch.cuda.max_memory_allocated() / 2 ** 30,
                          "captures": step.captures}
            states[name] = state_on_host(step)
            del step
        finally:
            restore()
    differ = equal_states(torch, states["remat_off"], states["remat_on"])
    res = {**runs, "state_leaves": len(states["remat_off"]),
           "state_leaves_differing": differ,
           "determinism_cost": runs["remat_off"]["replay_ms"]
           / runs["nondeterministic"]["replay_ms"],
           "peak_gb_saved": runs["remat_off"]["peak_allocated_gb"]
           - runs["remat_on"]["peak_allocated_gb"], "card": card}
    log(f"resnet50 remat [{card}]: {json.dumps(res)}")
    if runs["remat_off"]["losses"] != runs["remat_on"]["losses"] or differ \
            or not all(np.isfinite(runs["remat_on"]["losses"])) \
            or any(r["captures"] != 1 for r in runs.values()):
        raise AssertionError(f"resnet50 remat changed the run: {res}")
    return res


def rn_s2d(torch, card: str) -> dict:
    """(e) The space-to-depth stem against the plain stem, fp32, within
    RN_S2D_TOL (rtol and atol, as the JAX test): ResNet-50's stem conv on
    RN_SMALL_BATCH images of RN_HW, and the JAX test's own model
    (``ResNet(BasicBlock, [1, 1, 1, 1], 10)``, NHWC, eval mode, two
    24 x 24 images) end to end; ResNet-50's eval logits beside them
    (reported: at its initial statistics they reach ~4e3, so their gap
    is relative to the largest)."""
    from paddle_tpu_torch.models import BasicBlock, ResNet
    from paddle_tpu_torch.models.resnet import _space_to_depth_stem
    rng = np.random.default_rng(SEED + 220)

    def within(got, want) -> bool:
        return bool(((got - want).abs()
                     <= RN_S2D_TOL + RN_S2D_TOL * want.abs()).all())

    net = rn50(torch, "float32").eval()
    x = torch.from_numpy(rng.standard_normal(
        (RN_SMALL_BATCH, RN_HW, RN_HW, 3), dtype=np.float32)).to(RN_DEVICE)
    small = ResNet(BasicBlock, [1, 1, 1, 1], 10, data_format="NHWC",
                   device=RN_DEVICE, seed=SEED).eval()
    xs = torch.from_numpy(rng.standard_normal(
        (2, 24, 24, 3), dtype=np.float32)).to(RN_DEVICE)
    with torch.no_grad():
        stem = net.conv1(x)
        stem_s2d = _space_to_depth_stem(x, net.conv1.weight)
        outs = {}
        for s2d in (False, True):
            net.s2d_stem = small.s2d_stem = s2d
            outs[s2d] = (net(x), small(xs))
    res = {"stem_max_abs_diff": float((stem_s2d - stem).abs().max()),
           "stem_max_abs": float(stem.abs().max()),
           "stem_within_tol": within(stem_s2d, stem),
           "small_logits_max_abs_diff": float(
               (outs[True][1] - outs[False][1]).abs().max()),
           "small_within_tol": within(outs[True][1], outs[False][1]),
           "resnet50_logits_max_rel_gap": rel_gap(
               torch, outs[True][0], outs[False][0].cpu()),
           "resnet50_logits_max_abs": float(outs[False][0].abs().max()),
           "tolerance": RN_S2D_TOL, "card": card}
    log(f"resnet s2d stem: {json.dumps(res)}")
    if not (res["stem_within_tol"] and res["small_within_tol"]):
        raise AssertionError(f"resnet s2d stem: {res}")
    return res


def rn_state(step) -> dict:
    """A step's whole training state on the host but the scaler's."""
    return {k: v for k, v in state_on_host(step).items()
            if not k.startswith("scaler/")}


def rn_skip_drill(torch, card: str) -> dict:
    """(f) The small ResNet cast to fp16 under ``TrainStep(amp_dtype=
    "float16", scaler=GradScaler())`` and Momentum, fed a batch with one
    inf pixel: eager, and as the replay of a captured step (its first
    step a clean batch): the parameters, fp32 masters, velocities, step
    counter and BatchNorm buffers (which the forward rewrote with NaN)
    bit for bit what they were, the step counted non-finite."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import TrainStep
    rng = np.random.default_rng(SEED + 230)
    x = torch.from_numpy(rng.standard_normal(
        (RN_SMALL_BATCH, RN_SMALL_HW, RN_SMALL_HW, 3), dtype=np.float32)).to(
        RN_DEVICE, torch.float16)
    y = torch.from_numpy(rng.integers(0, RN_CLASSES, RN_SMALL_BATCH)).to(
        RN_DEVICE)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("inf")
    res = {}
    for compiled in (False, True):
        step = TrainStep(rn_small(torch, dtype="float16"),
                         Momentum(0.1, 0.9), rn_loss, seed=SEED,
                         amp_dtype="float16", scaler=GradScaler(),
                         compiled=compiled)
        if compiled:
            step(x, labels=(y,))
        before = rn_state(step)
        step(bad, labels=(y,))
        torch.cuda.synchronize()
        changed = equal_states(torch, before, rn_state(step))
        name = "captured_replay" if compiled else "eager"
        res[name] = {"changed": changed,
                     "buffers_checked": sum(k.startswith("buffers/")
                                            for k in before),
                     "leaves_checked": len(before),
                     "nonfinite_steps": int(step.nonfinite_steps),
                     "captures": step.captures}
        if changed or int(step.nonfinite_steps) < 1 \
                or step.captures != int(compiled) \
                or not res[name]["buffers_checked"]:
            raise AssertionError(f"resnet skip drill ({name}): {res}")
        del step
    log(f"resnet skip drill [{card}]: {json.dumps(res)}")
    return res


def rn_optimizers(sigma: float = 0.0) -> dict:
    """Constructors of the eleven optimizers and the four wrappers (over
    Momentum), with ``sigma`` for Dpsgd."""
    from paddle_tpu_torch import optimizer as O

    def mom():
        return O.Momentum(0.05, 0.9)

    return {
        "LarsMomentum": lambda: O.LarsMomentum(0.1, 0.9, lars_coeff=0.001,
                                               lars_weight_decay=5e-4),
        "Adamax": lambda: O.Adamax(1e-3),
        "Adagrad": lambda: O.Adagrad(1e-2, initial_accumulator_value=0.1),
        "Adadelta": lambda: O.Adadelta(1.0, rho=0.9),
        "RMSProp": lambda: O.RMSProp(1e-3, momentum=0.5, centered=True),
        "Lamb": lambda: O.Lamb(1e-3, lamb_weight_decay=0.01),
        "Ftrl": lambda: O.Ftrl(0.1, l1=0.01, l2=0.01),
        "Dpsgd": lambda: O.Dpsgd(1e-2, clip=1.0, batch_size=8.0,
                                 sigma=sigma),
        "DecayedAdagrad": lambda: O.DecayedAdagrad(1e-2),
        "ProximalGD": lambda: O.ProximalGD(1e-2, l1=0.01, l2=0.01),
        "ProximalAdagrad": lambda: O.ProximalAdagrad(1e-2, l1=0.01,
                                                     l2=0.01),
        "ExponentialMovingAverage": lambda: O.ExponentialMovingAverage(
            mom(), 0.9),
        "ModelAverage": lambda: O.ModelAverage(mom(),
                                               max_average_window=2),
        "Lookahead": lambda: O.Lookahead(mom(), alpha=0.5, k=2),
        "GradientMerge": lambda: O.GradientMerge(mom(), k_steps=2),
    }


def rn_sweep(torch, shapes: dict, card: str) -> dict:
    """(g) Each optimizer and wrapper: RN_SWEEP_STEPS updates of
    ResNet-50's own leaves (fp32, numpy values from a seed) on the card
    and on the CPU, every parameter and state tensor within TOL of its
    largest entry (Dpsgd at sigma 0: the two devices' generators differ);
    then the small ResNet trained RN_SWEEP_STEPS steps by an eager and a
    captured TrainStep from the same weights and batches, with
    ``deterministic`` on (Dpsgd at sigma 1, its noise from the step's
    generator): every leaf of the training state bit for bit."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.static import TrainStep
    rng = np.random.default_rng(SEED + 240)
    values = {n: rng.standard_normal(s, dtype=np.float32) * 0.05
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s, dtype=np.float32)
              for n, s in shapes.items()} for _ in range(RN_SWEEP_STEPS)]
    leaves = {}
    for name, make in rn_optimizers().items():
        out = {}
        for dev in (RN_DEVICE, "cpu"):
            opt = make()
            params = {n: torch.from_numpy(v).to(dev, copy=True)
                      for n, v in values.items()}
            state = opt.init(params)
            for g in grads:
                opt.apply_gradients(params, {n: torch.from_numpy(v).to(dev)
                                             for n, v in g.items()}, state)
            out[dev] = {k: v.detach().to("cpu", copy=True)
                        for k, v in io.flatten({"params": params,
                                                "opt": state}).items()}
        gaps = grad_gaps(torch, out[RN_DEVICE], out["cpu"])
        worst = max(gaps, key=gaps.get)
        leaves[name] = {"max_rel_gap": gaps[worst], "worst": worst,
                        "tensors": len(gaps)}
        if gaps[worst] > TOL or set(out["cpu"]) != set(out[RN_DEVICE]):
            raise AssertionError(f"optimizer sweep {name}: card and CPU "
                                 f"disagree: {leaves[name]}")
    rng = np.random.default_rng(SEED + 250)
    batches = [(torch.from_numpy(rng.standard_normal(
        (RN_SMALL_BATCH, RN_SMALL_HW, RN_SMALL_HW, 3),
        dtype=np.float32)).to(RN_DEVICE),
        torch.from_numpy(rng.integers(0, RN_CLASSES, RN_SMALL_BATCH)).to(
            RN_DEVICE)) for _ in range(RN_SWEEP_STEPS)]
    captured = {}
    restore = flag_scope({"deterministic": True})
    try:
        for name, make in rn_optimizers(sigma=1.0).items():
            states, losses = {}, {}
            for compiled in (False, True):
                step = TrainStep(rn_small(torch), make(), rn_loss,
                                 seed=SEED, compiled=compiled)
                losses[compiled] = [float(step(x, labels=(y,))["loss"])
                                    for x, y in batches]
                states[compiled] = state_on_host(step)
                caps = step.captures
                del step
            differ = equal_states(torch, states[False], states[True])
            captured[name] = {"losses": losses[True], "captures": caps,
                              "leaves": len(states[True]),
                              "leaves_differing": differ}
            if differ or losses[False] != losses[True] or caps != 1 \
                    or not all(np.isfinite(losses[True])):
                raise AssertionError(f"optimizer sweep {name}: captured "
                                     f"and eager differ: {captured[name]}")
    finally:
        restore()
    res = {"card_vs_cpu": leaves, "captured_vs_eager": captured,
           "leaves": len(shapes), "tolerance": TOL, "card": card}
    log(f"optimizer sweep [{card}]: {json.dumps(res)}")
    return res


def rn_resume(torch, card: str) -> dict:
    """(h) ResNet-50 bf16 at b RN_RESUME_BATCH through ``Model.fit``
    (Momentum(0.1, 0.9), ``deterministic`` on) for RN_EPOCHS epochs of
    RN_STEPS steps uninterrupted; then one epoch with ``ckpt_dir`` and
    ``save_steps=RN_SAVE_AT`` and a fresh Model over the same directory
    for RN_EPOCHS epochs (it restores step RN_SAVE_AT): the losses and
    every leaf of the training state (parameters, fp32 masters,
    velocities, step counter, BatchNorm buffers, generator) bit for
    bit."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Momentum
    shutil.rmtree(RN_DIR, ignore_errors=True)
    ds = ImageSamples(torch, RN_RESUME_BATCH * RN_STEPS, RN_HW, SEED + 260)

    def model():
        return Model(rn50(torch), loss=rn_loss,
                     optimizer=Momentum(0.1, 0.9))

    restore = flag_scope({"deterministic": True})
    try:
        torch.cuda.empty_cache()
        m = model()
        rec_u = hapi_recorder(torch)
        m.fit(rn_loader(torch, ds, RN_RESUME_BATCH), epochs=RN_EPOCHS,
              verbose=0, callbacks=[rec_u])
        end_u = state_on_host(m._train_step)
        del m
        m1 = model()
        rec1 = hapi_recorder(torch)
        m1.fit(rn_loader(torch, ds, RN_RESUME_BATCH), epochs=1, verbose=0,
               ckpt_dir=RN_DIR, save_steps=RN_SAVE_AT, callbacks=[rec1])
        saved = io.AsyncCheckpointer(RN_DIR).intact_steps()
        del m1
        m2 = model()
        rec2 = hapi_recorder(torch)
        m2.fit(rn_loader(torch, ds, RN_RESUME_BATCH), epochs=RN_EPOCHS,
               verbose=0, ckpt_dir=RN_DIR, save_steps=RN_SAVE_AT,
               callbacks=[rec2])
        end_r = state_on_host(m2._train_step)
        del m2
    finally:
        restore()
        shutil.rmtree(RN_DIR, ignore_errors=True)
    losses_u = [float(v) for v in rec_u.losses]
    losses_r = [float(v) for v in rec1.losses + rec2.losses]
    differ = equal_states(torch, end_u, end_r)
    res = {"batch": RN_RESUME_BATCH, "steps": len(losses_u),
           "saved_at": saved, "losses": losses_u,
           "losses_resumed": losses_r, "state_leaves": len(end_u),
           "buffers": sum(k.startswith("buffers/") for k in end_u),
           "leaves_differing": differ, "card": card}
    log(f"resnet50 resume [{card}]: {json.dumps(res)}")
    if losses_r != losses_u or differ or saved[:1] != [RN_SAVE_AT] \
            or len(losses_u) != RN_EPOCHS * RN_STEPS:
        raise AssertionError(f"resnet50 resume: {res}")
    return res


def run_resnet(torch) -> tuple:
    """Phase 12. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    t0 = time.perf_counter()
    report["rn_fit"], c, shapes, ds = rn_fit(torch, card)
    counts.update(c)
    report["rn_lars"] = rn_lars(torch, ds, card)
    report["rn_remat"] = rn_remat(torch, ds, card)
    del ds
    report["rn_main_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["rn_card_vs_cpu"] = rn_card_against_cpu(torch, card)
    report["rn_s2d"] = rn_s2d(torch, card)
    report["rn_skip_drill"] = rn_skip_drill(torch, card)
    report["rn_checks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["rn_sweep"] = rn_sweep(torch, shapes, card)
    report["rn_sweep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["rn_resume"] = rn_resume(torch, card)
    report["rn_resume_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    report["rn_phase_s"] = time.perf_counter() - t_phase
    log(f"resnet phase: {report['rn_phase_s']:.1f} s [{card}]")
    return report, counts


# ---------------------------------------------------------------------------
# phase 13: data, tensor and context parallelism (paddle_tpu_torch.parallel)
# ---------------------------------------------------------------------------

# (a) BERT-base bf16 fused (phase 10's configuration and data) through
# Model.prepare(mesh=create_mesh({"dp": 1})).fit under NCCL at world 1,
# ZeRO 0 (the flat fused state, as phase 10) and ZeRO 1 and 3 (per-leaf
# state: ZeRO refuses the flat one, as the JAX package does)
DIST_ZERO_STAGES = (0, 1, 3)
# (b) ResNet-50 bf16 NHWC b128 (phase 12's configuration), one epoch of
# RN_STEPS captured steps, SyncBatchNorm under the world-1 mesh against
# plain BatchNorm; bf16 tolerance on the loss and on every BatchNorm
# statistic (relative to the statistic's largest entry)
DIST_RN_TOL = 2e-2
# (c) four ranks sharing the card under Gloo, started by launch_procs:
# ring attention (flash route) and Ulysses at BERT-base heads over
# DIST_T tokens (DIST_T / 4 a rank), forward and gradients against the
# plain attention over the whole sequence in this process; a 2-layer
# BERT-base (no dropout, fp32) at dp 4 (ZeRO 1) and dp 2 x mp 2 (the
# Megatron rule), under the default flags and under phase 10's fused ones
# (the fused MLM head hands parameters to the loss), against one
# process's TrainStep under the same flags on the global batch; the
# straggler drill
DIST_WORLD = 4
DIST_T, DIST_HEADS, DIST_HEAD_DIM = 4 * 4096, 12, 64
DIST_LR = 1e-4
DIST_BERT = dict(bert_layers=2, bert_batch=8, bert_seq=128, bert_masked=20,
                 bert_steps=3, bert_lr=DIST_LR)
# 3xTF32 kernels against fp32 plain attention, relative to the
# reference's largest entry; the BERT runs against one process (the
# gradient summed over ranks in another order): the loss, and every
# parameter within DIST_PARAM_TOL, which lies between the sound runs'
# readings (up to 1.01e-5 on an H100) and that of a state the steps left
# unchanged (about lr a step: each run reports it and requires it above
# the bound)
DIST_ATTN_TOL, DIST_GRAD_TOL = 1e-4, 1e-3
DIST_LOSS_TOL = 1e-5
DIST_PARAM_TOL = 5e-5
DIST_JOB_TIMEOUT_S = 420.0
DIST_DIR = "chip_smoke_dist"  # the ranks' files (removed after the phase)
DIST_DEVICE = "cuda"
DIST_ATTN = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
PATH_KERNELS.update({
    "dist_fit": PATH_KERNELS["train_seq512_bf16_fused"],
    "dist_fit_zero1": PATH_KERNELS["train_seq512_bf16_fused"],
    "dist_fit_zero3": PATH_KERNELS["train_seq512_bf16_fused"],
    "rn_sync_fit": (),
    # rank 3 of the causal ring runs every hop through
    # flash_attention_with_lse (B8 over B1/B2)
    "dist_ring": DIST_ATTN, "dist_ulysses": DIST_ATTN,
    # rank 0 of (c)'s BERT under the fused flags: the fused MLM head's
    # loss and the Adam kernel on the rank's shards
    "dist_bert_dp4_fused": ("layer_norm", "fused_xent_fwd", "adam_leaf"),
    "dist_bert_dp2mp2_fused": ("layer_norm", "fused_xent_fwd",
                               "adam_leaf")})


def dist_fit(torch, card: str) -> tuple:
    """(a): the fits, each held against phase 10's bare fit run here on
    the same batches (ZeRO 0: every state leaf bit for bit; ZeRO 1/3:
    the losses and every parameter bit for bit; whether the losses equal
    phase 10's own run is reported); launches the per-step
    counts times the steps; the steady step stream ms, the captures, the
    NCCL calls a step (those one capture recorded) and the peak memory.
    Returns (report, counts)."""
    from paddle_tpu_torch import kernels, parallel
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import collective
    parallel.init_parallel_env()
    mesh = parallel.create_mesh({"dp": 1})
    net = hapi_bert(torch, HAPI_LAYERS)
    cfg = net.config
    del net
    base = hapi_samples(torch, cfg, SEED + 100)
    ds = PackedSamples(base)
    per_epoch = HAPI_SAMPLES // RESUME_BATCH
    steps = HAPI_EPOCHS * per_epoch
    per_step = expected_launches(RESUME_SEQ, HAPI_LAYERS,
                                 cfg.hidden_size // cfg.num_attention_heads,
                                 FUSED_FLAGS,
                                 rows=RESUME_BATCH * RESUME_MASKED,
                                 vocab=cfg.vocab_size)
    runs, counts, ends = {}, {}, {}
    for name, zero in [("bare", None)] + [
            (f"zero{z}", z) for z in DIST_ZERO_STAGES]:
        model = Model(hapi_bert(torch, HAPI_LAYERS), loss=packed_loss,
                      optimizer=AdamW(1e-4, weight_decay=0.01,
                                      fused_state=zero in (None, 0)))
        if zero is not None:
            model.prepare(mesh=mesh, zero_stage=zero)
        rec = hapi_recorder(torch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        collective.reset_backend_calls()
        t0 = time.perf_counter()
        model.fit(make_loader(torch, ds), epochs=HAPI_EPOCHS, verbose=0,
                  callbacks=[rec])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        c = kernels.launch_counts()
        step = model._train_step
        calls = collective.backend_calls().get("nccl", 0)
        runs[name] = {
            "zero_stage": zero, "losses": [float(v) for v in rec.losses],
            "step_ms": steady_step_ms(rec.events, per_epoch),
            "captures": step.captures, "capture_ms": step.capture_ms,
            # a captured step is one graph replay a step; the warm-up ran
            # each collective once and the capture recorded it once
            "host_calls_per_step": 1 if step.compiled else None,
            "nccl_calls": calls,
            "nccl_calls_per_step": calls / (2 * step.captures)
            if step.captures else None,
            "launches": nonzero(c), "fit_s": fit_s,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "type": type(step).__name__}
        ends[name] = state_on_host(step)
        if zero is not None:
            counts["dist_fit" if zero == 0 else f"dist_fit_zero{zero}"] = c
            path_launches(f"dist_fit zero {zero}", c, per_step, steps)
        del model, step
        torch.cuda.empty_cache()
    ref = REPORT.get("hapi_fit", {}).get("losses_fit")
    params = [k for k in ends["bare"] if k.startswith("params/")]
    for name in runs:
        if name == "bare":
            continue
        keys = None if name == "zero0" else params
        a = ends["bare"] if keys is None else {k: ends["bare"][k]
                                               for k in keys}
        b = ends[name] if keys is None else {k: ends[name][k] for k in keys}
        runs[name]["leaves_differing_from_bare"] = equal_states(torch, a, b)
        runs[name]["losses_equal_bare"] = \
            runs[name]["losses"] == runs["bare"]["losses"]
        runs[name]["losses_equal_phase10"] = None if ref is None \
            else runs[name]["losses"] == ref
        bare_ms = runs["bare"]["step_ms"]
        runs[name]["step_ms_over_bare"] = runs[name]["step_ms"] / bare_ms \
            if bare_ms and runs[name]["step_ms"] else None
    res = {"runs": runs, "steps": steps, "batch": RESUME_BATCH,
           "seq": RESUME_SEQ, "layers": HAPI_LAYERS, "dtype": "bfloat16",
           "per_step_launches": per_step, "card": card}
    log(f"dist fit [{card}]: {json.dumps(res)}")
    bad = [n for n, r in runs.items() if n != "bare" and (
        r["leaves_differing_from_bare"] or not r["losses_equal_bare"]
        or r["captures"] != 1
        or r["type"] != "ShardedTrainStep" or not r["nccl_calls"])]
    if bad or len(runs["bare"]["losses"]) != steps:
        raise AssertionError(f"dist fit: {bad}: {res}")
    return res, counts


def rn_sync(torch, card: str) -> dict:
    """(b): ResNet-50 with SyncBatchNorm under the world-1 mesh through
    Model.prepare(mesh=).fit against the plain BatchNorm net's fit on the
    same batches: losses and every BatchNorm statistic within
    DIST_RN_TOL, ms a step of each."""
    from paddle_tpu_torch import kernels, parallel
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import SyncBatchNorm
    from paddle_tpu_torch.optimizer import Momentum
    mesh = parallel.create_mesh({"dp": 1})
    ds = ImageSamples(torch, RN_BATCH * RN_STEPS, RN_HW, SEED + 200)
    out = {}
    for name in ("plain", "sync"):
        net = rn50(torch)
        if name == "sync":
            SyncBatchNorm.convert_sync_batchnorm(net)
        model = Model(net, loss=rn_loss, optimizer=Momentum(0.1, 0.9))
        if name == "sync":
            model.prepare(mesh=mesh)
        rec = hapi_recorder(torch)
        kernels.reset_launch_counts()
        model.fit(rn_loader(torch, ds, RN_BATCH), epochs=1,
                  callbacks=[rec], verbose=0)
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        out[name] = {"losses": [float(v) for v in rec.losses],
                     "step_ms": steady_step_ms(rec.events, RN_STEPS),
                     "captures": model._train_step.captures,
                     "counts": c, "launches": nonzero(c),
                     "buffers": host_copy(dict(net.named_buffers()))}
        del model, net
        torch.cuda.empty_cache()
    errs = {}
    for n, want in out["plain"]["buffers"].items():
        got = out["sync"]["buffers"][n].double()
        want = want.double()
        errs[n] = float((got - want).abs().max() / want.abs().max()
                        .clamp(min=1e-30))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(
        out["sync"]["losses"], out["plain"]["losses"]))
    res = {"losses_plain": out["plain"]["losses"],
           "losses_sync": out["sync"]["losses"],
           "loss_max_rel_err": loss_err,
           "stat_max_rel_err": max(errs.values()),
           "stat_worst": max(errs, key=errs.get),
           "step_ms_plain": out["plain"]["step_ms"],
           "step_ms_sync": out["sync"]["step_ms"],
           "captures": [out["plain"]["captures"], out["sync"]["captures"]],
           "launches": [out["plain"]["launches"], out["sync"]["launches"]],
           "batch": RN_BATCH, "steps": RN_STEPS, "tol": DIST_RN_TOL,
           "card": card}
    log(f"resnet50 sync bn [{card}]: {json.dumps(res)}")
    res["counts"] = out["sync"]["counts"]
    if loss_err > DIST_RN_TOL or res["stat_max_rel_err"] > DIST_RN_TOL \
            or res["captures"] != [1, 1] or any(res["launches"]) \
            or not all(np.isfinite(out["sync"]["losses"])):
        raise AssertionError(f"resnet50 sync bn: {res}")
    return res


def plain_attention_reference(torch, q, k, v, g, causal: bool):
    """out, dq, dk, dv of plain fp32 attention over the whole sequence on
    the card, a head at a time (scores of one head: T x T)."""
    outs = [[], [], [], []]
    scale = 1.0 / math.sqrt(q.shape[-1])
    for h in range(q.shape[1]):
        qh, kh, vh = (torch.tensor(a[:, h:h + 1], device=DIST_DEVICE)
                      .requires_grad_(True) for a in (q, k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            t = s.shape[-1]
            keep = torch.ones(t, t, dtype=torch.bool, device=DIST_DEVICE).tril()
            s = s.masked_fill(~keep, float("-inf"))
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vh)
        grads = torch.autograd.grad(
            (o * torch.tensor(g[:, h:h + 1], device=DIST_DEVICE)).sum(),
            [qh, kh, vh])
        for lst, t_ in zip(outs, (o,) + tuple(grads)):
            lst.append(t_.detach().cpu().numpy())
        del qh, kh, vh, s, o, grads
    return [np.concatenate(x, axis=1) for x in outs]


def dist_ranks(torch, card: str) -> tuple:
    """(c): the ``chip`` job of paddle_tpu_torch.testing.dist_worker on
    DIST_WORLD ranks (Gloo, cuda:0) through launch_procs, then the
    references in this process. Returns (report, counts)."""
    from paddle_tpu_torch.testing import dist_worker as W
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    outs = W.run_job("chip", DIST_DIR, DIST_WORLD,
                     {k: np.asarray(v) for k, v in chip_job_inputs().items()},
                     timeout_s=DIST_JOB_TIMEOUT_S,
                     env={"PT_WORKER_DEVICE": DIST_DEVICE,
                          "PT_DIST_BACKEND": "gloo"})
    job_s = time.perf_counter() - t0
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    res, counts = check_chip_job(torch, outs, card)
    res["job_s"] = job_s
    log(f"dist ranks [{card}]: {json.dumps(res)}")
    if res["bad"]:
        raise AssertionError(f"dist ranks: {res['bad']}")
    return res, counts


def chip_job_inputs() -> dict:
    """The inputs of dist_worker's ``chip`` job (phase 13 (c))."""
    return dict(seed=SEED + 300, heads=DIST_HEADS, t=DIST_T,
                d=DIST_HEAD_DIM, **DIST_BERT)


def check_chip_job(torch, outs, card: str) -> tuple:
    """The ``chip`` job's outputs held against the references in this
    process (see :func:`dist_ranks`): (report with its ``bad`` list,
    counts)."""
    from paddle_tpu_torch.kernels.flash_attention import backward_route
    from paddle_tpu_torch.testing import dist_worker as W
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.static import TrainStep
    res, counts = {"world": DIST_WORLD, "t": DIST_T, "heads": DIST_HEADS,
                   "head_dim": DIST_HEAD_DIM, "card": card}, {}
    q, k, v, g = W.attention_inputs(SEED + 300, 1, DIST_HEADS, DIST_T,
                                    DIST_HEAD_DIM)
    tl = DIST_T // DIST_WORLD
    route = backward_route(tl, tl, DIST_HEAD_DIM)
    uroute = backward_route(DIST_T, DIST_T, DIST_HEAD_DIM)
    bad = []
    for causal in (False, True):
        ref = plain_attention_reference(torch, q, k, v, g, causal)
        for kind in ("ring", "ulysses"):
            tag = f"{kind}/{'causal' if causal else 'full'}"
            errs = {}
            for j, name in enumerate(("out", "dq", "dk", "dv")):
                got = np.concatenate([o[f"{tag}/{name}"] for o in outs],
                                     axis=2)
                errs[name] = float(np.abs(got - ref[j]).max()
                                   / np.abs(ref[j]).max())
            launches, want = [], []
            for r, o in enumerate(outs):
                c = dict(zip(o[f"{tag}/launch_names"].tolist(),
                             o[f"{tag}/launches"].tolist()))
                launches.append(nonzero(c))
                hops = (r + 1 if causal else DIST_WORLD) \
                    if kind == "ring" else 1
                bwd = ("flash_attention_bwd_fused",) if (
                    route if kind == "ring" else uroute) == "fused" \
                    else ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
                want.append({n: hops for n in ("flash_attention_fwd",)
                             + bwd})
                if kind == "ring" and causal and r == DIST_WORLD - 1:
                    counts["dist_ring"] = c
                if kind == "ulysses" and causal and r == 0:
                    counts["dist_ulysses"] = c
            res[tag] = {"max_rel_err": errs, "launches_by_rank": launches,
                        "ms_by_rank": [float(o[f"{tag}/ms"]) for o in outs]}
            if launches != want or errs["out"] > DIST_ATTN_TOL or max(
                    errs[n] for n in ("dq", "dk", "dv")) > DIST_GRAD_TOL:
                bad.append((tag, errs, launches, want))
        del ref
        torch.cuda.empty_cache()
    # the BERT runs against one process's TrainStep on the global batch,
    # under the same flags
    batch = [torch.tensor(a, device=DIST_DEVICE) for a in W.bert_batch(
        SEED + 301, DIST_BERT["bert_batch"], DIST_BERT["bert_seq"],
        DIST_BERT["bert_masked"], 30522)]
    want = {}
    for fused in (False, True):
        model = W.chip_bert(torch, DIST_BERT["bert_layers"], SEED + 300,
                            DIST_DEVICE)
        init = {n: p.detach().cpu().numpy().copy()
                for n, p in model.named_parameters()}
        step = TrainStep(model, AdamW(DIST_LR, weight_decay=0.01,
                                      fused_state=False), pretraining_loss)
        restore = flag_scope(W.FUSED_FLAGS if fused else
                             {k: False for k in W.FUSED_FLAGS})
        try:
            losses = [float(step(*batch[:4], labels=tuple(batch[4:]))[
                "loss"]) for _ in range(DIST_BERT["bert_steps"])]
        finally:
            restore()
        params = {n: p.detach().cpu().numpy()
                  for n, p in model.named_parameters()}
        # what the parameter check reads when the steps change nothing
        unchanged = max(float(np.abs(params[n] - init[n]).max())
                        for n in params)
        want[fused] = losses, params, unchanged
        del model, step, init
    for name, _, _, fused in W.CHIP_BERT_RUNS:
        want_losses, want_params, unchanged = want[fused]
        total = sum(p.size for p in want_params.values())
        loss_err = max(float(np.abs(o[f"bert_{name}/loss"]
                                    - want_losses).max()) / abs(
            want_losses[0]) for o in outs)
        errs = {n: max(float(np.abs(o[f"bert_{name}/param/{n}"] - w).max())
                       for o in outs) for n, w in want_params.items()}
        worst = max(errs, key=errs.get)
        shards = [int(o[f"bert_{name}/shard_numel"]) for o in outs]
        c = dict(zip(outs[0][f"bert_{name}/launch_names"].tolist(),
                     outs[0][f"bert_{name}/launches"].tolist()))
        res[f"bert_{name}"] = {
            "held_numel_rank0": int(outs[0][f"bert_{name}/held_numel"]),
            "losses": outs[0][f"bert_{name}/loss"].tolist(),
            "losses_one_process": want_losses,
            "loss_max_rel_err": loss_err, "param_max_abs_err": errs[worst],
            "param_worst": worst, "param_bound": DIST_PARAM_TOL,
            "param_unchanged_reading": unchanged,
            "shard_numel_by_rank": shards, "params": total,
            "launches_rank0": nonzero(c),
            "ms_by_rank": [o[f"bert_{name}/ms"].tolist() for o in outs]}
        launched = True
        if fused:
            counts[f"dist_bert_{name}"] = c
            # every rank ran the fused head's loss and the Adam kernel
            launched = all(
                dict(zip(o[f"bert_{name}/launch_names"].tolist(),
                         o[f"bert_{name}/launches"].tolist())).get(k, 0) > 0
                for o in outs for k in PATH_KERNELS[f"dist_bert_{name}"])
            res[f"bert_{name}"]["path_kernels_on_every_rank"] = launched
        if loss_err > DIST_LOSS_TOL or errs[worst] > DIST_PARAM_TOL \
                or unchanged <= DIST_PARAM_TOL or max(shards) >= total \
                or not launched:
            bad.append((name, res[f"bert_{name}"]))
    flagged = [o["straggler/flagged"].tolist() for o in outs]
    res["straggler"] = {"flagged_by_rank": flagged,
                        "slowed": W.STRAGGLER_RANK}
    if flagged != [[W.STRAGGLER_RANK]] * DIST_WORLD:
        bad.append(("straggler", flagged))
    res["bad"] = bad
    return res, counts


def run_distributed(torch) -> tuple:
    """Phase 13. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    restore = flag_scope(FUSED_FLAGS)
    try:
        t0 = time.perf_counter()
        report["dist_fit"], c = dist_fit(torch, card)
        counts.update(c)
        report["dist_fit_s"] = time.perf_counter() - t0
    finally:
        restore()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["rn_sync"] = rn_sync(torch, card)
    counts["rn_sync_fit"] = report["rn_sync"].pop("counts")
    report["rn_sync_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["dist_ranks"], c = dist_ranks(torch, card)
    counts.update(c)
    report["dist_ranks_s"] = time.perf_counter() - t0
    report["dist_phase_s"] = time.perf_counter() - t_phase
    import torch.distributed as dist
    dist.destroy_process_group()  # (a)'s world-1 NCCL group
    log(f"distributed phase: {report['dist_phase_s']:.1f} s [{card}]")
    return report, counts


# ---------------------------------------------------------------------------
# phase 14: pipeline, LocalSGD, DGC, fleet and the parameter server, with
# tensor parallelism and ZeRO 3 partitioned for real
# ---------------------------------------------------------------------------

# (a) four Gloo ranks sharing the card (dist_worker's ``chip14`` job, one
# startup for every case), each case against the same algorithm in this
# process on the global batch: GPipe over BERT-base (12 layers in 4 stages
# of 3, M = 4, b 32, seq 128); on phase 13 (c)'s 2-layer full-width BERT
# (b 8, seq 128): tensor parallelism dp 2 x mp 2 with ZeRO 3 (13 (c)'s
# dp2mp2 runs are plain TP, partitioned since this phase came), LocalSGD
# at dp 4 (k 2), DGC at dp 4 (Momentum, sparsity 0.99, rampup 1), fleet's
# sharding (stage 3) and gradient merge (k 2), sync PS training (2
# pserver shards, 2 trainers, an untied BERT's word embedding a sparse
# table looked up by the batch's ids); all
# under the fused flags with the flash route on at seq 128
DIST14 = dict(DIST_BERT, gpipe_layers=12, gpipe_batch=32, gpipe_micro=4)
DIST14_DIR = "chip_smoke_dist14"
DIST14_CASES = ("gpipe", "tp_zero3", "localsgd", "dgc", "fleet_sharding",
                "fleet_merge", "ps")
# the loss's and every parameter's bound, as 13 (c)'s; the PS run's
# gradients are averaged by the servers in another order, its step is
# CHIP14_PS_LR x the gradient
DIST14_LOSS_TOL, DIST14_PARAM_TOL = DIST_LOSS_TOL, DIST_PARAM_TOL
# DGC's top-k: the reference sends the entries each rank sent, and holds
# the rank's choice to a top-k of its own accumulator: the largest
# magnitude left out may exceed the smallest taken by DGC_SELECT_TOL of the
# k-th largest plus DGC_ROUNDING of the replica's largest entry (the two
# accumulators differ by the rounding of the gradient's kernels, and the
# key projection's bias has a gradient of 0 in exact arithmetic, softmax
# ignoring a shift common to a query's keys, so its entries are rounding
# alone); a choice that is not a top-k reads thousands of times that
DGC_SELECT_TOL, DGC_ROUNDING = 1e-4, 1e-6
# (b) under NCCL, one rank a card (only with four cards): phase 13 (c)'s
# job and 13 (a)'s fits at world 4 (dp 4, ZeRO 0/1/3; FIT4 global batches
# of FIT4_BATCH), (a)'s job, and BERT-base bf16 fused at seq 512,
# one global batch of 4 x NCCL_BATCH rows, captured: ZeRO 0 and ZeRO 3
# at dp 4 (NCCL_BATCH rows a rank), TP dp 2 x mp 2 (twice that a dp
# replica, whose two ranks split its heads and FFN). The fits and the
# runs are held against one card's run of the same steps: the losses
# within DIST14_BF16_TOL (the sums over ranks round elsewhere; an
# unchanged model must read more) and the parameters within
# DIST14_MOVE_TOL
FIT4 = dict(fit_batches=4, fit_batch=32, fit_masked=72)
NCCL14 = dict(nccl_batch=8, nccl_steps=6, nccl_seq=512, nccl_layers=12)
DIST14_BF16_TOL = 2e-3
# tensor parallelism rounds each row-parallel partial product to bf16
# before its all-reduce over mp, so its bf16 losses drift further from
# one card's (2.1e-3 on H100s, against 0.12 for an unchanged model; in
# fp32, phase 14 (a), TP is within 1e-6 of one process)
DIST14_TP_BF16_TOL = 1e-2
# a bf16 run's parameters against the reference run's: the L2 distance of
# the two runs' moves from their common start over the reference's move
# (``dist_worker.move_error``; a run that changed nothing reads 1)
DIST14_MOVE_TOL = 0.2
_XENT_ADAM = ("fused_xent_fwd", "fused_xent_bwd_dlog", "fused_xent_bwd_dh",
              "fused_xent_bwd_dw")


def dist14_path_kernels() -> dict:
    """What each phase-14 case must launch on every rank that trains: the
    LayerNorm, the flash route at seq 128, the fused head's loss, and the
    Adam kernel where the optimizer is AdamW."""
    from paddle_tpu_torch.kernels.flash_attention import backward_route
    seq = DIST14["bert_seq"]
    bwd = ("flash_attention_bwd_fused",) if backward_route(
        seq, seq, DIST_HEAD_DIM) == "fused" else (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    base = ("layer_norm", "flash_attention_fwd") + bwd + _XENT_ADAM
    return {f"dist14_{c}": base + (() if c in ("dgc", "ps")
                                   else ("adam_leaf",))
            for c in DIST14_CASES}


def ps_run(torch, model, batch, steps: int, trainers: int = 1):
    """The sync PS run of one trainer over two fresh pserver shards in
    this process, ``model`` an untied BERT whose word embedding is a
    sparse table looked up by the batch's ids: (losses, dense params and
    the word embedding)."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed.ps import (PSCluster, PSTrainStep,
                                                 SparseEmbeddingPS)
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.testing import dist_worker as W
    servers = [native.PsServer(), native.PsServer()]
    try:
        cluster = PSCluster([f"127.0.0.1:{s.port}" for s in servers])
        emb = SparseEmbeddingPS(cluster, "word", model.config.hidden_size,
                                optimizer="sgd", lr=W.CHIP14_PS_LR,
                                init_scale=0.02)
        step = PSTrainStep(model, pretraining_loss, cluster, mode="sync",
                           n_trainers=trainers, optimizer="sgd",
                           lr=W.CHIP14_PS_LR,
                           sparse_tables={W.PS_WORD: (emb, 0)})
        losses = [step(*batch[:4], labels=(batch[4], batch[5]))["loss"]
                  for _ in range(steps)]
        params = dict(step.params)
        params[W.PS_WORD] = emb.pull(np.arange(model.config.vocab_size))
        cluster.close()
    finally:
        for s_ in servers:
            s_.stop()
    return losses, params


def dgc_reference(torch, model, batch, steps: int, world: int, lr: float,
                  sent: dict):
    """DGC in one process: each replica's gradient on its rows, the
    momentum-corrected top-k exchange of the JAX module's header (dense
    for the first ``rampup_steps``), SGD with the exchanged update (the
    optimizer's momentum zeroed). Past the warm-up each replica sends the
    entries its rank sent, ``sent[(step, rank, name)]``, so a near tie
    that rounding breaks the other way on the rank moves no parameter; the
    choice itself is held here: ``gaps[name]``, the largest of (the
    largest magnitude left out - the smallest taken) of this process's
    accumulator over what rounding allows (``DGC_SELECT_TOL`` of the
    k-th largest + ``DGC_ROUNDING`` of the replica's largest entry): <= 0
    when the rank's entries are a top-k of it, <= 1 within rounding; and
    ``flips[name]``, how many of them ``topk_sparsify`` here would not
    have taken. Returns (losses, params, gaps, flips)."""
    from paddle_tpu_torch.core import random as _random
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.parallel import topk_sparsify
    from paddle_tpu_torch.testing import dist_worker as W
    cfg = W.CHIP14_DGC
    params = dict(model.named_parameters())
    vel = [{n: torch.zeros_like(p) for n, p in params.items()}
           for _ in range(world)]
    res = [{n: torch.zeros_like(p) for n, p in params.items()}
           for _ in range(world)]
    rows = batch[0].shape[0] // world
    gen = torch.Generator(device=batch[0].device).manual_seed(0)
    losses, gaps, flips = [], {}, {}
    for i in range(steps):
        grads, step_losses = [], []
        for r in range(world):
            part = [t[r * rows:(r + 1) * rows] for t in batch]
            with _random.rng_scope(default=gen, dropout=gen):
                loss = pretraining_loss(model(*part[:4]), part[4], part[5])
            grads.append(dict(zip(params, torch.autograd.grad(
                loss, list(params.values())))))
            step_losses.append(float(loss.detach()))
        losses.append(float(np.mean(step_losses)))
        with torch.no_grad():
            # each replica's largest accumulated entry: DGC_ROUNDING of
            # it is the rounding floor of the choice's gap
            floor = [DGC_ROUNDING * max(
                float((res[r][n] + cfg["momentum"] * vel[r][n]
                       + grads[r][n]).abs().max()) for n in params)
                for r in range(world)]
            for n, p in params.items():
                upd = torch.zeros(p.numel(), device=p.device)
                accs = []
                for r in range(world):
                    u = cfg["momentum"] * vel[r][n] + grads[r][n]
                    acc = res[r][n] + u
                    accs.append(acc)
                    if i < cfg["rampup_steps"]:
                        vel[r][n] = u
                        res[r][n] = torch.zeros_like(acc)
                        continue
                    flat = acc.reshape(-1)
                    idx = torch.as_tensor(sent[(i, r, n)],
                                          device=p.device).long()
                    k = idx.numel()
                    mine = topk_sparsify(acc, k)[1]
                    mag = flat.abs()
                    kth = float(mag[mine].min())
                    if k < flat.numel():
                        left = mag.index_fill(0, idx, -1.0).max()
                        gap = float(left - mag[idx].min()) / (
                            DGC_SELECT_TOL * kth + floor[r])
                        gaps[n] = max(gaps.get(n, gap), gap)
                    taken = torch.zeros(flat.numel(), dtype=torch.bool,
                                        device=p.device)
                    taken[mine] = True
                    flips[n] = flips.get(n, 0) + int(
                        (~taken[idx]).sum())
                    upd.index_add_(0, idx, flat[idx])
                    res[r][n] = flat.index_fill(0, idx, 0.0).reshape(
                        acc.shape)
                    vel[r][n] = u.reshape(-1).index_fill(
                        0, idx, 0.0).reshape(u.shape)
                upd = (torch.stack(accs).mean(0) if i < cfg["rampup_steps"]
                       else (upd / world).reshape(p.shape))
                p.sub_(lr * upd)
    return losses, {n: p.detach() for n, p in params.items()}, gaps, flips


def dgc_sent(outs, tag: str = "") -> dict:
    """The entries each rank's DGC run sent: {(step, rank, name):
    indices} from (a)'s outputs (``tag`` prefixes their keys)."""
    prefix = f"{tag}dgc/sent/"
    return {(int(k[len(prefix):].split("/", 1)[0]), r,
             k[len(prefix):].split("/", 1)[1]): v
            for r, o in enumerate(outs) for k, v in o.items()
            if k.startswith(prefix)}


def dist14_references(torch, dev: str, widths: dict, sent: dict) -> dict:
    """Phase 14 (a)'s cases run in this process on the global batches:
    {case: (losses, {name: param})}; a pipeline's names are the whole
    model's. The DGC reference sends what the ranks sent (``sent``, from
    :func:`dgc_sent`) and its ``dgc_choice`` holds that choice."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.static import TrainStep
    from paddle_tpu_torch.testing import dist_worker as W
    inputs = dict(seed=SEED + 300, **DIST14,
                  **{f"width/{k}": v for k, v in widths.items()})
    seed, lr, steps = SEED + 300, DIST14["bert_lr"], DIST14["bert_steps"]
    layers = DIST14["bert_layers"]

    def opt():
        return AdamW(lr, weight_decay=0.01, fused_state=False)

    def host(params):
        return {n: np.array(p.detach().float().cpu().numpy()
                            if isinstance(p, torch.Tensor) else p)
                for n, p in params.items()}

    def moved(init, end):
        """What the parameter check reads when the steps change nothing:
        the largest move of any entry."""
        return max(float(np.abs(end[n] - init[n]).max()) for n in init)

    refs = {}
    restore = flag_scope(W.CHIP14_FLAGS)
    try:
        gb = W.chip14_batch(torch, inputs, dev, DIST14["gpipe_batch"],
                            DIST14["bert_seq"], 1)
        model = W.chip_bert(torch, DIST14["gpipe_layers"], seed, dev,
                            **widths)
        init = host(dict(model.named_parameters()))
        step = TrainStep(model, opt(), pretraining_loss)
        losses, _ = W._run_steps(torch, step, gb, steps, pipeline=True)
        end = host(dict(model.named_parameters()))
        refs["gpipe"] = losses, end, moved(init, end)
        del model, step
        batch = W.chip14_batch(torch, inputs, dev, DIST14["bert_batch"],
                               DIST14["bert_seq"], 2)
        model = W.chip_bert(torch, layers, seed, dev, **widths)
        init = host(dict(model.named_parameters()))
        step = TrainStep(model, opt(), pretraining_loss)
        losses, _ = W._run_steps(torch, step, batch, steps)
        end = host(dict(model.named_parameters()))
        refs["tp_zero3"] = refs["fleet_sharding"] = (
            losses, end, moved(init, end))
        del model, step
        s = fleet.DistributedStrategy()
        s.gradient_merge, s.gradient_merge_configs.k_steps = True, 2
        model = W.chip_bert(torch, layers, seed, dev, **widths)
        step = fleet.apply_strategy(s, model, opt(), pretraining_loss,
                                    mesh=create_mesh({"dp": 1}))
        losses, _ = W._run_steps(torch, step, batch, steps)
        end = host(dict(model.named_parameters()))
        refs["fleet_merge"] = losses, end, moved(init, end)
        del model, step
        # LocalSGD: four replicas on their rows, averaged every k steps
        k, rows = W.CHIP14_LOCALSGD_K, DIST14["bert_batch"] // DIST_WORLD
        reps = [W.chip_bert(torch, layers, seed, dev, **widths)
                for _ in range(DIST_WORLD)]
        rsteps = [TrainStep(m, opt(), pretraining_loss) for m in reps]
        losses = []
        for call in range(2 * k):
            ls = [W._run_steps(torch, st, [t[r * rows:(r + 1) * rows]
                                           for t in batch], 1)[0][0]
                  for r, st in enumerate(rsteps)]
            losses.append(float(np.mean(ls)))
            if (call + 1) % k == 0:
                with torch.no_grad():
                    for n in rsteps[0].params:
                        leaves = [[st.params[n]] + [
                            v for v in st.state["slots"][n].values()
                            if v.ndim > 0] for st in rsteps]
                        for j in range(len(leaves[0])):
                            mean = torch.stack([lv[j] for lv in leaves]
                                               ).mean(0)
                            for lv in leaves:
                                lv[j].copy_(mean)
        ends = [host(dict(m.named_parameters())) for m in reps]
        refs["localsgd"] = losses, ends, moved(init, ends[0])
        del reps, rsteps
        model = W.chip_bert(torch, layers, seed, dev, **widths)
        losses, params, gaps, flips = dgc_reference(
            torch, model, batch, steps, DIST_WORLD, W.CHIP14_DGC["lr"],
            sent)
        end = host(params)
        refs["dgc"] = losses, end, moved(init, end)
        refs["dgc_choice"] = gaps, flips
        del model
        model = W.untied_bert(torch, layers, seed, dev, **widths)
        init = host(dict(model.named_parameters()))
        losses, params = ps_run(torch, model, batch, steps)
        end = host(params)
        # the word embedding's first value is the table's, not the
        # model's: its move is left out of the reading
        refs["ps"] = losses, end, moved(
            {n: v for n, v in init.items() if n != W.PS_WORD}, end)
        del model
    finally:
        restore()
    return refs


def _pipe_name(n: str, stage: int, per: int) -> str:
    """A GPipe step's parameter name as the whole BERT names it."""
    if n.startswith("embed."):
        return "bert.embeddings." + n[len("embed."):]
    if n.startswith("head.pooler."):
        return "bert." + n[len("head."):]
    if n.startswith("head.cls."):
        return n[len("head."):]
    parts = n.split(".")  # stages.layers.<j>.<rest>
    return ".".join(["bert.encoder.layers", str(stage * per + int(parts[2]))]
                    + parts[3:])


def check_dist14(torch, outs, refs: dict, card: str, tag: str = "") -> tuple:
    """(a)'s outputs (``tag`` prefixes their keys) against ``refs``:
    (report with its ``bad`` list, counts of rank 0 or the first
    trainer)."""
    want_kernels = dist14_path_kernels()
    res, counts, bad = {"card": card}, {}, []
    per = DIST14["gpipe_layers"] // DIST_WORLD
    for case in DIST14_CASES:
        ranks = [r for r in range(len(outs))
                 if f"{tag}{case}/loss" in outs[r]]
        want_losses, want_params, unchanged = refs[case]
        per_rank = [np.asarray(outs[r][f"{tag}{case}/loss"])
                    for r in ranks]
        if case == "ps":  # each trainer's loss is its half's
            per_rank = [np.mean(per_rank, axis=0)]
        got_losses = per_rank[0]
        loss_err = max(float(np.abs(g - want_losses).max())
                       for g in per_rank) / abs(want_losses[0])
        errs = {}
        for r in ranks:
            prefix = f"{tag}{case}/param/"
            for k, v in outs[r].items():
                if not k.startswith(prefix):
                    continue
                n = k[len(prefix):]
                if case == "gpipe":
                    n = _pipe_name(n, r, per)
                w = want_params[r][n] if case == "localsgd" \
                    else want_params[n]
                errs[n] = max(errs.get(n, 0.0),
                              float(np.abs(v - w).max()))
        worst = max(errs, key=errs.get)
        c = [dict(zip(outs[r][f"{tag}{case}/launch_names"].tolist(),
                      outs[r][f"{tag}{case}/launches"].tolist()))
             for r in ranks]
        counts[f"dist14_{case}"] = c[0]
        launched = all(ci.get(kname, 0) > 0 for ci in c
                       for kname in want_kernels[f"dist14_{case}"])
        res[case] = {
            "losses": np.asarray(got_losses).tolist(),
            "losses_one_process": list(want_losses),
            "loss_max_rel_err": loss_err, "param_max_abs_err": errs[worst],
            "param_worst": worst, "params_checked": len(errs),
            "param_bound": DIST14_PARAM_TOL,
            "param_unchanged_reading": unchanged,
            "ranks": ranks, "path_kernels_on_every_rank": launched,
            "ms_by_rank": [outs[r][f"{tag}{case}/ms"].tolist()
                           for r in ranks],
            "peak_gb_by_rank": [float(outs[r][f"{tag}{case}/peak_gb"])
                                for r in ranks
                                if f"{tag}{case}/peak_gb" in outs[r]],
            "launches_rank": nonzero(c[0])}
        chose_wrong = False
        if case == "dgc":
            gaps, flips = refs["dgc_choice"]
            gap_worst = max(gaps, key=gaps.get)
            res[case].update(
                select_gap_max=gaps[gap_worst], select_gap_leaf=gap_worst,
                select_gap_bound=1.0,
                leaves_sent=len(flips),
                flips_by_leaf={n: f for n, f in flips.items() if f},
                sent_by_step_rank=sum(
                    1 for k in outs[0] if k.startswith(f"{tag}dgc/sent/")))
            chose_wrong = gaps[gap_worst] > 1.0
        if loss_err > DIST14_LOSS_TOL or errs[worst] > DIST14_PARAM_TOL \
                or unchanged <= DIST14_PARAM_TOL or not launched \
                or chose_wrong or not np.all(np.isfinite(got_losses)):
            bad.append((case, res[case]))
    held = [int(sum(v for k, v in o.items()
                    if k.startswith(f"{tag}tp_zero3/held_numel/")))
            for o in outs]
    total = sum(v.size for v in refs["tp_zero3"][1].values())
    res["tp_zero3"]["held_numel_by_rank"] = held
    res["tp_zero3"]["params"] = total
    if max(held) * 2 > total:
        bad.append(("tp_zero3 holds more than half", held, total))
    res["bad"] = bad
    return res, counts


def run_dist14(torch, card: str) -> tuple:
    """(a) on this card: the ``chip14`` job under Gloo, then the
    references. Returns (report, counts)."""
    from paddle_tpu_torch.testing import dist_worker as W
    shutil.rmtree(DIST14_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    outs = W.run_job("chip14", DIST14_DIR, DIST_WORLD,
                     {k: np.asarray(v) for k, v in dict(
                         seed=SEED + 300, **DIST14).items()},
                     timeout_s=DIST_JOB_TIMEOUT_S,
                     env={"PT_WORKER_DEVICE": DIST_DEVICE,
                          "PT_DIST_BACKEND": "gloo"})
    job_s = time.perf_counter() - t0
    shutil.rmtree(DIST14_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = dist14_references(torch, DIST_DEVICE, {}, dgc_sent(outs))
    res, counts = check_dist14(torch, outs, refs, card)
    res.update(job_s=job_s, references_s=time.perf_counter() - t0,
               backend="gloo", note="four ranks share one card: times are "
               "not data-parallel speed")
    log(f"dist14 gloo [{card}]: {json.dumps(res)}")
    if res["bad"]:
        raise AssertionError(f"dist14: {res['bad']}")
    return res, counts


def fit_reference(torch, dev: str, widths: dict) -> tuple:
    """13 (a)'s data at world 4 through one card's bare fit: (its losses,
    the losses of the unchanged model on the same batches, its parameters
    and their start, on the host)."""
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing import dist_worker as W
    n, b = FIT4["fit_batches"], FIT4["fit_batch"]
    data = W.bert_batch(SEED + 300 + 5, n * b, NCCL14["nccl_seq"],
                        FIT4["fit_masked"], widths.get("vocab_size", 30522))
    batches = [tuple(a[i * b:(i + 1) * b] for a in data[:4])
               + (np.concatenate([data[4][i * b:(i + 1) * b],
                                  data[5][i * b:(i + 1) * b, None]], 1),)
               for i in range(n)]
    rec = hapi_recorder(torch)
    restore = flag_scope(FUSED_FLAGS)
    try:
        net = cast_model_to_low_precision(W.chip_bert(
            torch, NCCL14["nccl_layers"], SEED + 300, dev, **widths),
            "bfloat16")
        init = {k: p.detach().to("cpu", copy=True)
                for k, p in net.named_parameters()}
        with torch.no_grad():
            unchanged = []
            for bt in batches:
                x = [torch.as_tensor(a, device=dev) for a in bt]
                unchanged.append(float(pretraining_loss(
                    net(*x[:4]), x[4][:, :-1], x[4][:, -1])))
        m = Model(net, loss=lambda o, y: pretraining_loss(
            o, y[:, :-1], y[:, -1]), optimizer=AdamW(
                1e-4, weight_decay=0.01, fused_state=True))
        m.fit(batches, epochs=1, verbose=0, callbacks=[rec])
        end = {k: p.detach().to("cpu", copy=True)
                for k, p in net.named_parameters()}
    finally:
        restore()
    losses = [float(v) for v in rec.losses]
    del m, net
    return losses, unchanged, end, init


def run_nccl14(torch, card: str) -> tuple:
    """(b): dist_worker's ``chip_nccl`` job under NCCL, one rank a card,
    held against (a)'s and 13 (c)'s references and a one-card fit.
    Returns (report, counts)."""
    from paddle_tpu_torch.testing import dist_worker as W
    n = torch.cuda.device_count()
    if n < DIST_WORLD:
        msg = (f"phase 14 (b) not run: {n} CUDA device(s), it needs "
               f"{DIST_WORLD} (one NCCL rank a card; run "
               f"`python chip_smoke.py --distributed` on four cards)")
        log(msg)
        return {"ran": False, "why": msg}, {}
    shutil.rmtree(DIST14_DIR, ignore_errors=True)
    inputs = dict(chip_job_inputs(), **DIST14, **FIT4, **NCCL14)
    t0 = time.perf_counter()
    try:
        outs = W.run_job("chip_nccl", DIST14_DIR, DIST_WORLD,
                         {k: np.asarray(v) for k, v in inputs.items()},
                         timeout_s=3 * DIST_JOB_TIMEOUT_S,
                         env={"PT_WORKER_DEVICE": DIST_DEVICE,
                              "PT_DIST_BACKEND": "nccl"})
    except RuntimeError:
        # the ranks' whole logs, for the report (the error has their tails)
        os.makedirs("chiprun_out", exist_ok=True)
        for r in range(DIST_WORLD):
            src = os.path.join(DIST14_DIR, f"rank{r}.log")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(
                    "chiprun_out", f"chip_smoke_nccl_rank{r}.log"))
        raise
    job_s = time.perf_counter() - t0
    shutil.rmtree(DIST14_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    res, counts = check_nccl14(torch, outs, card, DIST_DEVICE, {})
    res["job_s"] = job_s
    log(f"dist14 nccl [{card}]: {json.dumps(res)}")
    if res["bad"]:
        raise AssertionError(f"dist14 nccl: {res['bad']}")
    return res, counts


def check_nccl14(torch, outs, card: str, dev: str, widths: dict) -> tuple:
    """(b)'s outputs against (a)'s and 13 (c)'s references and a one-card
    fit: (report with its ``bad`` list, counts)."""
    from paddle_tpu_torch.testing import dist_worker as W
    res = {"ran": True, "backend": "nccl", "card": card,
           "parts_s": {p: float(outs[0][f"{p}/s"])
                       for p in ("c", "a", "14a", "14b")}}
    c_outs = [{k[2:]: v for k, v in o.items() if k.startswith("c/")}
              for o in outs]
    res["13c"], counts13 = check_chip_job(torch, c_outs, card)
    refs = dist14_references(torch, dev, widths, dgc_sent(outs, "14a/"))
    res["14a"], counts = check_dist14(torch, outs, refs, card, tag="14a/")
    bad = [("13c", b) for b in res["13c"]["bad"]] + [
        ("14a", b) for b in res["14a"]["bad"]]
    want, unchanged, one_end, one_init = fit_reference(torch, dev, widths)

    def rel(got, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(got, ref))

    fits = {"loss_bound": DIST14_BF16_TOL, "move_bound": DIST14_MOVE_TOL,
            "loss_unchanged_reading": rel(unchanged, want)}
    z0_end = {n[len("a/fit0/param/"):]: torch.from_numpy(v).view(
        torch.bfloat16) for n, v in outs[0].items()
        if n.startswith("a/fit0/param/")}
    for z in (0, 1, 3):
        got = [o[f"a/fit{z}/loss"].tolist() for o in outs]
        err = max(rel(g, want) for g in got)
        if z == 0:  # the world-4 fit's move against the one card's
            moves = [W.move_error(torch, z0_end, one_end, one_init)[0]]
        else:  # every rank's against ZeRO 0's at world 4
            moves = [float(o[f"a/fit{z}/move_err_vs_zero0"][0])
                     for o in outs]
        fits[f"zero{z}"] = {
            "losses": got[0], "loss_max_rel_err": err,
            "move_err": max(moves),
            "move_err_against": "one card" if z == 0 else "zero0",
            "captures": [int(o[f"a/fit{z}/captures"]) for o in outs],
            "fit_s": float(outs[0][f"a/fit{z}/s"]),
            "peak_gb_by_rank": [float(o[f"a/fit{z}/peak_gb"]) for o in outs]}
        if err > DIST14_BF16_TOL or max(moves) > DIST14_MOVE_TOL \
                or not all(np.isfinite(got[0])):
            bad.append((f"fit zero{z}", fits[f"zero{z}"]))
    if fits["loss_unchanged_reading"] <= DIST14_BF16_TOL:
        bad.append(("fit: the unchanged model passes the loss bound",
                    fits["loss_unchanged_reading"]))
    res["13a_world4"] = dict(fits, losses_one_card=want, **FIT4)
    del z0_end, one_end, one_init
    runs = {}
    for name, axes, zero, tp in W.CHIP_NCCL_RUNS:
        runs[name] = {
            "axes": axes, "zero_stage": zero, "tensor_parallel": tp,
            "losses": outs[0][f"14b/{name}/loss"].tolist(),
            "step_ms_by_rank": [float(np.median(o[f"14b/{name}/ms"][2:]))
                                for o in outs],
            "peak_gb_by_rank": [float(o[f"14b/{name}/peak_gb"])
                                for o in outs],
            "param_bytes_rank0": int(outs[0][f"14b/{name}/param_bytes"]),
            "state_bytes_rank0": int(outs[0][f"14b/{name}/state_bytes"]),
            "captures": int(outs[0][f"14b/{name}/captures"]),
            "launches_rank0": nonzero(dict(zip(
                outs[0][f"14b/{name}/launch_names"].tolist(),
                outs[0][f"14b/{name}/launches"].tolist())))}
    z0, z3, tp_ = runs["zero0"], runs["zero3"], runs["tp"]
    # each run against rank 0's one-card run of the same steps: the
    # losses, and the fp32 masters' moves (whole model, and the worst
    # leaf for the record); an unchanged state reads the loss reading
    # below and 1 for the moves
    one = outs[0]["14b/one/loss"].tolist()
    held = {"losses_one_card": one, "loss_bound": DIST14_BF16_TOL,
            "move_bound": DIST14_MOVE_TOL,
            "loss_unchanged_reading": rel([one[0]] * len(one), one)}
    ok = held["loss_unchanged_reading"] > DIST14_TP_BF16_TOL
    for name in runs:
        move = outs[0][f"14b/{name}/master_move_err"]
        bound = DIST14_TP_BF16_TOL if runs[name]["tensor_parallel"] \
            else DIST14_BF16_TOL
        held[name] = {
            "loss_max_rel_err": rel(runs[name]["losses"], one),
            "loss_bound": bound,
            "master_move_err": float(move[0]),
            "master_move_err_worst_leaf": float(move[1]),
            "worst_leaf": str(outs[0][f"14b/{name}/master_worst_leaf"])}
        ok = ok and held[name]["loss_max_rel_err"] <= bound \
            and held[name]["master_move_err"] <= DIST14_MOVE_TOL
    runs["against_one_card"] = held
    if not ok or z3["param_bytes_rank0"] * 3 \
            > z0["param_bytes_rank0"] or tp_["param_bytes_rank0"] \
            >= z0["param_bytes_rank0"] or max(z3["peak_gb_by_rank"]) \
            >= max(z0["peak_gb_by_rank"]) or any(
                r["captures"] != 1 for r in (z0, z3, tp_)):
        bad.append(("14b", runs))
    res["14b"] = dict(runs, **NCCL14, dtype="bfloat16")
    res["bad"] = bad
    return res, {f"nccl_{k}": v for k, v in dict(counts13, **counts).items()}


def run_phase14(torch) -> tuple:
    """Phase 14. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    report["dist14"], counts = run_dist14(torch, card)
    report["dist14_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    report["nccl14"], c = run_nccl14(torch, card)
    counts.update(c)
    report["nccl14_s"] = time.perf_counter() - t0
    report["phase14_s"] = time.perf_counter() - t_phase
    log(f"phase 14: {report['phase14_s']:.1f} s [{card}]")
    return report, counts


# ---------------------------------------------------------------------------
# phase 15: the static programming model and the core op library (A17 part
# 1): ERNIE 1.0 base (PaddlePaddle/ERNIE's ernie_config.json: L 12, H 768,
# A 12, vocab 18,000, 513 positions, relu; dropout 0.1) seeded, in bf16
# with the fused loss and Adam kernel (flat fused state), b8 x s512:
# (a) trained from slot files through Executor.train_from_dataset (an
# InMemoryDataset of ERNIE_STEPS batches, knowledge-masked units), 2
# epochs, against a bare TrainStep loop on the same batches (bit for bit);
# (b) to_static(ErnieModel) in eval (fp32): one capture, replays bit for
# bit the eager forward, exported with jit.save and loaded (within TOL,
# phase 9's bound); (c) Executor.run of a Program whose to_static function
# computes the MLM loss from the Scope's parameters with a tensor `if`, its
# clone(for_test=True) and check_nan_inf; (d) the converted functions of
# tests/test_dy2static.py on the card against the CPU; (e) every public
# function of the eight op modules on the card against the CPU, and
# matmul_precision's two precisions. `python3 chip_smoke.py --static` runs
# this phase alone.
# ---------------------------------------------------------------------------

ERNIE_CFG = dict(vocab_size=18000, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="relu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=513, type_vocab_size=2)
ERNIE_BATCH, ERNIE_SEQ, ERNIE_STEPS, ERNIE_EPOCHS = 8, 512, 4, 2
ERNIE_MASK_ID, ERNIE_MASK_PROB = 3, 0.15
ERNIE_DIR = "chip_smoke_ernie"
# the fused loss against the unfused one on the same bf16 model and batch
# (eval, one forward): the fused kernels read the bf16 hidden states in
# fp32, the unfused logits are a bf16 matmul; a wrong label or row mask is
# O(1)
ERNIE_FUSED_TOL = 5e-3
# card against CPU in the op sweep: fp32 (~1e-6 relative expected; a few
# ulps of the transcendental functions), integers and bools exact
OPS_RTOL, OPS_ATOL = 2e-5, 1e-6
# random ops: draws a call, and the moment bound in standard errors
OPS_RANDOM_N, OPS_MOMENT_SE = 200_000, 6.0
# matmul_precision: [4096, 768] x [768, 3072] fp32 against float64; TF32
# keeps 10 mantissa bits (~1e-3 relative), IEEE fp32 ~1e-6
MATMUL_SHAPE = (4096, 768, 3072)
# where phase 15 runs (a CPU rehearsal sets "cpu")
P15_DEVICE = "cuda"
TF32_MIN_ERR = 1e-4
FP32_MAX_ERR = 1e-5
PATH_KERNELS.update({
    "ernie_static_fit": ("layer_norm", "flash_attention_fwd",
                         "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                         "fused_xent_fwd", "fused_xent_bwd_dlog",
                         "fused_xent_bwd_dh", "fused_xent_bwd_dw",
                         "adam_leaf"),
    # the eval forward at s 512 and head dim 64: attention takes the plain
    # composition (flash_attention_min_seq 8192 and the head-dim rule gate
    # the eval route), so LayerNorm alone
    "ernie_to_static": ("layer_norm",)})


def ernie_records(n: int, seed: int) -> tuple:
    """``n`` records from numpy ``seed``: token ids (4.. of the vocabulary)
    masked by ``knowledge_mask`` over random units of 1-4 tokens, their MLM
    labels (-100 where unmasked) and NSP labels."""
    from paddle_tpu_torch.models.ernie import knowledge_mask
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, ERNIE_CFG["vocab_size"], (n, ERNIE_SEQ))
    spans = []
    for _ in range(n):
        row, s = [], 0
        while s < ERNIE_SEQ:
            e = min(ERNIE_SEQ, s + int(rng.integers(1, 5)))
            row.append((s, e))
            s = e
        spans.append(row)
    masked, mlm = knowledge_mask(ids, spans, ERNIE_MASK_ID,
                                 ERNIE_CFG["vocab_size"], ERNIE_MASK_PROB,
                                 rng=rng)
    nsp = rng.integers(0, 2, (n, 1))
    return masked, mlm, nsp


def ernie_slot_files(directory: str) -> list:
    """The records as two MultiSlot files (slots: input_ids, mlm, nsp)."""
    n = ERNIE_BATCH * ERNIE_STEPS
    masked, mlm, nsp = ernie_records(n, SEED + 15)
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    files = []
    for part in range(2):
        path = os.path.join(directory, f"part-{part}")
        with open(path, "w") as f:
            for i in range(part * n // 2, (part + 1) * n // 2):
                f.write(" ".join(f"{len(v)} " + " ".join(map(str, v))
                                 for v in (masked[i], mlm[i], nsp[i]))
                        + "\n")
        files.append(path)
    return files


def ernie_loss(out, mlm, nsp):
    from paddle_tpu_torch.models.ernie import pretraining_loss
    return pretraining_loss(out, mlm, nsp.reshape(-1))


def ernie_model(torch, dtype: str = "bfloat16", heads: bool = True):
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForPretraining,
                                               ErnieModel)
    cfg = ErnieConfig(**ERNIE_CFG)
    if heads:
        model = ErnieForPretraining(cfg, device=P15_DEVICE, seed=SEED)
    else:
        model = ErnieModel(cfg, device=P15_DEVICE,
                           generator=torch.Generator(device=P15_DEVICE)
                           .manual_seed(SEED))
    return cast_model_to_low_precision(model, dtype) \
        if dtype != "float32" else model


def ernie_fused_against_unfused(torch, model, batch) -> dict:
    """One eval forward of the same model and batch with the fused loss
    and without it."""
    def loss(fused: bool) -> float:
        restore = flag_scope({"fused_softmax_xent": fused})
        try:
            with torch.no_grad():
                return float(ernie_loss(model(batch[0]), *batch[1:]))
        finally:
            restore()

    model.eval()
    try:
        unfused, fused = loss(False), loss(True)
    finally:
        model.train()
    rel = abs(fused - unfused) / abs(unfused)
    if not rel <= ERNIE_FUSED_TOL:
        raise AssertionError(f"ernie: fused loss {fused} against unfused "
                             f"{unfused}: {rel} > {ERNIE_FUSED_TOL}")
    return {"fused": fused, "unfused": unfused, "rel_gap": rel,
            "bound": ERNIE_FUSED_TOL}


def ernie_static_fit(torch, card: str) -> tuple:
    """(a): train_from_dataset against a bare TrainStep loop."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.data import InMemoryDataset
    from paddle_tpu_torch.kernels.fused_softmax_xent import bwd_chunk
    from paddle_tpu_torch.static import Executor
    t0 = time.perf_counter()
    files = ernie_slot_files(ERNIE_DIR)
    ds = InMemoryDataset()
    ds.set_slots([("input_ids", "sparse", ERNIE_SEQ),
                  ("mlm", "sparse", ERNIE_SEQ), ("nsp", "sparse", 1)])
    ds.set_batch_size(ERNIE_BATCH)
    ds.set_thread(1)
    ds.set_filelist(files)
    loaded = ds.load_into_memory()
    load_s = time.perf_counter() - t0
    if loaded != ERNIE_BATCH * ERNIE_STEPS:
        raise AssertionError(f"ernie: loaded {loaded} records")
    batches = [tuple(torch.from_numpy(b[k]).to(P15_DEVICE)
                     for k in ("input_ids", "mlm", "nsp")) for b in ds]
    restore = flag_scope(FUSED_FLAGS)
    try:
        model = ernie_model(torch)
        fused_gap = ernie_fused_against_unfused(torch, model, batches[0])
        step = make_train_step(model, fused_state=True, loss_fn=ernie_loss)
        losses, events = [], []

        def handler(metrics):
            losses.append(metrics["loss"])
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        history = Executor().train_from_dataset(
            step, ds, input_slots=["input_ids"], label_slots=["mlm", "nsp"],
            epochs=ERNIE_EPOCHS, fetch_handler=handler)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(v) for v in losses]
        captures = step.captures
        del step, model
        torch.cuda.empty_cache()
        # the bare loop: the same model, seed and batches, step by step
        bare_model = ernie_model(torch)
        bare = make_train_step(bare_model, fused_state=True,
                               loss_fn=ernie_loss)
        bare_losses = []
        for _ in range(ERNIE_EPOCHS):
            for ids, mlm, nsp in batches:
                bare_losses.append(bare(ids, labels=(mlm, nsp))["loss"])
        bare_losses = [float(v) for v in bare_losses]
        del bare, bare_model
    finally:
        restore()
    shutil.rmtree(ERNIE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    steps = ERNIE_EPOCHS * ERNIE_STEPS
    rows = ERNIE_BATCH * ERNIE_SEQ
    per_step = expected_launches(ERNIE_SEQ, ERNIE_CFG["num_hidden_layers"],
                                 ERNIE_CFG["hidden_size"]
                                 // ERNIE_CFG["num_attention_heads"],
                                 FUSED_FLAGS, rows=rows,
                                 vocab=ERNIE_CFG["vocab_size"])
    chunks = -(-ERNIE_CFG["vocab_size"] // bwd_chunk(
        rows, ERNIE_CFG["vocab_size"]))
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(2, len(events))]
    step_ms = float(np.median(ms))
    res = {"config": ERNIE_CFG, "batch": ERNIE_BATCH, "seq": ERNIE_SEQ,
           "dtype": "bfloat16", "flags": FUSED_FLAGS, "epochs": ERNIE_EPOCHS,
           "steps": steps, "records": loaded, "load_s": load_s,
           "fit_s": fit_s, "epoch_losses": history, "losses": losses,
           "bare_losses": bare_losses,
           "bit_for_bit_with_bare_loop": losses == bare_losses,
           "captures": captures, "step_stream_ms": ms,
           "step_ms_median_after_capture": step_ms,
           "tokens_per_s": rows / step_ms * 1e3, "peak_allocated_gb": peak,
           "xent_bwd_chunks": chunks, "launches_per_step": nonzero(per_step),
           "fused_against_unfused": fused_gap, "card": card}
    log(f"ernie static fit [{card}]: {json.dumps(res)}")
    if chunks != per_step["fused_xent_bwd_dlog"] or chunks == 15:
        raise AssertionError(f"ernie: {chunks} xent chunks at V 18000 "
                             f"(per step {per_step})")
    if not all(np.isfinite(losses)) or losses != bare_losses:
        raise AssertionError(f"ernie: train_from_dataset {losses} against "
                             f"the bare loop {bare_losses}")
    means = [float(np.mean(losses[e * ERNIE_STEPS:(e + 1) * ERNIE_STEPS],
                           dtype=np.float64)) for e in range(ERNIE_EPOCHS)]
    if not np.allclose(history, means, rtol=1e-5):
        raise AssertionError(f"ernie: epoch losses {history} against the "
                             f"steps' means {means}")
    if captures != 1:
        raise AssertionError(f"ernie: {captures} captures over {steps} "
                             f"steps of one shape (drop_last)")
    path_launches("ernie_static_fit", counts, per_step, steps)
    return res, counts


def ernie_to_static(torch, card: str) -> tuple:
    """(b): to_static(ErnieModel) in eval, captured against eager, and its
    export."""
    from paddle_tpu_torch import jit, kernels
    model = ernie_model(torch, "float32", heads=False)
    model.eval()
    ids = torch.from_numpy(ernie_records(ERNIE_BATCH, SEED + 16)[0]).to(P15_DEVICE)
    sf = jit.to_static(model)
    with torch.no_grad():
        eager = [t.clone() for t in model(ids)]
        first = sf(ids)
        kernels.reset_launch_counts()
        again = sf(ids)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()

        def loop(fn, n=10):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n

        captured_ms = loop(lambda: sf(ids))
        eager_ms = loop(lambda: model(ids))
    bitwise = all(torch.equal(a, b) for a, b in zip(first, eager)) and all(
        torch.equal(a, b) for a, b in zip(again, eager))
    path = os.path.join(ERNIE_DIR, "export")
    shutil.rmtree(ERNIE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    jit.save(sf, path, input_spec=[jit.InputSpec([None, ERNIE_SEQ],
                                                 "int64")])
    save_s = time.perf_counter() - t0
    loaded = jit.load(path)
    got = loaded(ids[:3])
    with torch.no_grad():
        want = model(ids[:3])
    export_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    shutil.rmtree(ERNIE_DIR, ignore_errors=True)
    per_forward = {"layer_norm": 2 * ERNIE_CFG["num_hidden_layers"] + 1}
    res = {"batch": ERNIE_BATCH, "seq": ERNIE_SEQ, "dtype": "float32",
           "captures": sf.captures, "captured": sf.captured,
           "conversion_note": sf.conversion_note,
           "bit_for_bit_with_eager": bitwise, "captured_ms": captured_ms,
           "eager_ms": eager_ms, "capture_ms": sf.capture_ms,
           "launches_per_forward": nonzero(counts),
           "eval_attention_route": (
               "plain composition: flash_attention_min_seq (8192) and the "
               "head-dim rule (d % 128, or d % 8 from 8192 keys) gate the "
               "eval route; 512 keys at d 64 meet neither"),
           "export_save_s": save_s, "export_max_abs_err": export_err,
           "export_bound": TOL, "card": card}
    log(f"ernie to_static [{card}]: {json.dumps(res)}")
    if not bitwise or sf.captures != 1 or not sf.captured:
        raise AssertionError(f"ernie to_static: captures {sf.captures}, "
                             f"bit for bit {bitwise}")
    if nonzero(counts) != per_forward:
        raise AssertionError(f"ernie to_static: launches {counts} != "
                             f"{per_forward}")
    if not export_err <= TOL:
        raise AssertionError(f"ernie export: {export_err} > {TOL}")
    del sf, model, loaded
    torch.cuda.empty_cache()
    return res, counts


def ernie_mlm_static(params, model, ids, mlm, nsp, scale):
    """The Program's to_static body: ERNIE's pretraining loss with the
    scope's parameters, capped at 100 by a tensor `if` (a select on the
    card), times ``scale`` (the poisoned feed's route)."""
    import torch
    out = torch.func.functional_call(model, params, (ids,))
    loss = ernie_loss(out, mlm, nsp)
    if loss > 100.0:
        loss = loss * 0.0 + 100.0
    return loss * scale


def program_run(torch, card: str) -> dict:
    """(c): Executor.run of a Program over the Scope's parameters."""
    from paddle_tpu_torch import get_flags, jit
    from paddle_tpu_torch.static import Executor, Program, Scope
    model = ernie_model(torch, "float32")
    model.eval()
    scope = Scope()
    names = []
    for n, p in model.named_parameters():
        scope.set_var(n, p.detach())
        names.append(n)
    body = jit.to_static(ernie_mlm_static)

    def fn(state, feeds):
        return state, {"loss": body(state, model, feeds["ids"],
                                    feeds["mlm"], feeds["nsp"],
                                    feeds["scale"])}

    masked, mlm, nsp = ernie_records(ERNIE_BATCH, SEED + 17)
    feed = {"ids": masked, "mlm": mlm, "nsp": nsp,
            "scale": np.ones(1, np.float32)}
    prog = Program(fn, state_names=names, name="ernie_mlm")
    exe = Executor()
    with torch.no_grad():
        first = exe.run(prog, feed, ["loss"], scope=scope)[0]
        again = exe.run(prog, feed, ["loss"], scope=scope)[0]
        want = float(ernie_mlm_static(
            dict(model.named_parameters()), model,
            *(torch.from_numpy(feed[k]).to(P15_DEVICE)
              for k in ("ids", "mlm", "nsp", "scale"))))
        test_prog = prog.clone(for_test=True)
        test_loss = exe.run(test_prog, feed, ["loss"], scope=scope)[0]
        test_loss = exe.run(test_prog, feed, ["loss"], scope=scope)[0]

        def runs(n=10):
            exe.run(prog, feed, ["loss"], scope=scope)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                exe.run(prog, feed, ["loss"], scope=scope)
            return (time.perf_counter() - t0) / n * 1e3

        off_ms = runs()
        restore = flag_scope({"check_nan_inf": True})
        try:
            on_ms = runs()
            raised = None
            try:
                exe.run(prog, dict(feed, scale=np.full(1, np.inf,
                                                       np.float32)),
                        ["loss"], scope=scope)
            except FloatingPointError as e:
                raised = str(e)
            exe.run(prog, feed, ["loss"], scope=scope)  # clean: no raise
        finally:
            restore()
    if get_flags("check_nan_inf")["check_nan_inf"]:
        raise AssertionError("program_run: check_nan_inf left on")
    res = {"loss": float(first[0]), "replay_loss": float(again[0]),
           "eager_loss": want, "test_clone_loss": float(test_loss[0]),
           "captures": prog.captures, "captured": prog.captured,
           "test_clone_captures": test_prog.captures,
           "nan_inf_message": raised, "run_ms_check_off": off_ms,
           "run_ms_check_on": on_ms,
           "check_nan_inf_ms_a_run": on_ms - off_ms, "card": card}
    log(f"program run [{card}]: {json.dumps(res)}")
    if raised is None or "FLAGS_check_nan_inf" not in raised:
        raise AssertionError(f"program_run: a poisoned feed gave {raised}")
    # one graph for each value of check_nan_inf: every flag's value is
    # part of a capture's signature
    if prog.captures != 2 or test_prog.captures != 1 \
            or float(first[0]) != float(again[0]) \
            or float(test_loss[0]) != float(first[0]) \
            or abs(float(first[0]) - want) > TOL * abs(want):
        raise AssertionError(f"program_run: {res}")
    del model, scope, prog, test_prog
    torch.cuda.empty_cache()
    return res


# the converted functions of tests/test_dy2static.py (arithmetic only)

def d2s_if_on_tensor_value(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def d2s_nested_if(x):
    if x.sum() > 0:
        if x.sum() > 10:
            r = x * 100.0
        else:
            r = x * 10.0
    else:
        r = x
    return r


def d2s_early_return(x):
    if x.sum() > 0:
        return x * 10.0
    return x * -1.0


def d2s_mixed_partial_returns(x):
    if x.sum() > 0:
        if x.max() > 5:
            return x
    return -x


def d2s_while_on_tensor(x):
    s = x * 0.0
    while s.sum() < 10.0:
        s = s + x
    return s


def d2s_for_tensor_range(x):
    acc = x * 0.0
    for i in range(x.shape[0] * 0 + (x.abs().sum() > -1) * 4):
        acc = acc + x * (i + 1)
    return acc


def d2s_and_or_not(x):
    if (x.sum() > 0) and (x.max() < 100.0):
        return x + 1.0
    if not (x.sum() > 0) or (x.max() > 1000.0):
        return x - 1.0
    return x


D2S_CASES = {"if_on_tensor_value": (d2s_if_on_tensor_value, (1.0, -1.0)),
             "nested_if": (d2s_nested_if, (20.0, 2.0, -2.0)),
             "early_return": (d2s_early_return, (3.0, -3.0)),
             "mixed_partial_returns": (d2s_mixed_partial_returns,
                                       (9.0, 2.0, -1.0)),
             "while_on_tensor": (d2s_while_on_tensor, (3.0,)),
             "for_tensor_range": (d2s_for_tensor_range, (1.0,)),
             "and_or_not": (d2s_and_or_not, (5.0, 500.0, -5.0))}


def dy2static_cases(torch, card: str) -> dict:
    """(d): each function through to_static on the card (a capture or an
    eager signature with its reason) against the same on the CPU."""
    import warnings
    from paddle_tpu_torch.jit import to_static
    out, bad = {}, []
    for name, (fn, values) in D2S_CASES.items():
        sf, cpu = to_static(fn), to_static(fn)
        res = {"values": list(values)}
        for v in values:
            x = torch.tensor([v, v / 2], dtype=torch.float32)
            with warnings.catch_warnings(record=True) as warned:
                warnings.simplefilter("always")
                got = [sf(x.to(P15_DEVICE)) for _ in range(2)]
            want = cpu(x)
            ok = all(g.device.type == P15_DEVICE for g in got) and all(
                torch.allclose(g.cpu(), want, rtol=OPS_RTOL, atol=OPS_ATOL)
                for g in got)
            res.setdefault("equal_cpu", []).append(ok)
            res.setdefault("warned", []).append(len(warned))
            if not ok:
                bad.append((name, v, [g.tolist() for g in got],
                            want.tolist()))
        res.update(captured=sf.captured, captures=sf.captures,
                   eager_signatures=sf.eager_signatures, reason=sf.reason)
        loops = name in ("while_on_tensor", "for_tensor_range")
        if loops != (sf.eager_signatures == 1) or (
                loops and ("tensor" not in (sf.reason or "")
                           or sf.captures)) or (
                not loops and sf.captures != 1):
            bad.append((name, res))
        out[name] = res
    report = {"cases": out,
              "captured": sorted(n for n, r in out.items() if r["captured"]),
              "eager": sorted(n for n, r in out.items()
                              if not r["captured"]),
              "card": card}
    log(f"dy2static cases [{card}]: {json.dumps(report)}")
    if bad:
        raise AssertionError(f"dy2static cases: {bad}")
    return report


def _sweep_flat(out):
    import torch
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _sweep_flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _sweep_flat(o)]
    if isinstance(out, torch.Tensor):
        return [out]
    if hasattr(out, "data") and hasattr(out, "size"):  # a TensorArray
        return [out.data, out.size]
    return [out]


def _sweep_arg(torch, a, device):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.copy()).to(device)
    if isinstance(a, list) and a and isinstance(a[0], (np.ndarray, dict)):
        return [_sweep_arg(torch, v, device) for v in a]
    if isinstance(a, dict):
        return {k: _sweep_arg(torch, v, device) for k, v in a.items()}
    return a


def _sweep_args(torch, args, device):
    return [_sweep_arg(torch, a, device) for a in args]


def _sweep_compare(torch, card_out, cpu_out, what: str,
                   device: Optional[str] = None) -> float:
    got, want = _sweep_flat(card_out), _sweep_flat(cpu_out)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, {len(want)} on "
                             f"the CPU")
    worst = 0.0
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            if g != w:
                raise AssertionError(f"{what}: {g} != {w}")
            continue
        if g.device.type != (device or P15_DEVICE) or g.dtype != w.dtype \
                or g.shape != w.shape:
            raise AssertionError(f"{what}: {g.device} {g.dtype} "
                                 f"{tuple(g.shape)} against {w.dtype} "
                                 f"{tuple(w.shape)}")
        g = g.cpu()
        if w.is_floating_point():
            if not torch.allclose(g, w, rtol=OPS_RTOL, atol=OPS_ATOL,
                                  equal_nan=True):
                raise AssertionError(f"{what}: card {g} against CPU {w}")
            fin = torch.isfinite(w)
            if bool(fin.any()):
                worst = max(worst, float(((g - w).abs()[fin]
                                          / (w.abs()[fin] + OPS_ATOL))
                                         .max()))
        elif not torch.equal(g, w):
            raise AssertionError(f"{what}: card {g} against CPU {w}")
    return worst


def ops_sweep(torch, card: str) -> dict:
    """(e): every public function of the eight op modules on the card
    against the CPU; random ops by shape, dtype, device, moments and
    reproducibility; matmul_precision's two precisions."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.testing import op_cases as C
    mods = {m: getattr(ops, m) for m in C.MODULES}
    t0 = time.perf_counter()
    worst, done = 0.0, set()
    for mod, name, args, kw in C.CASES:
        fn = getattr(mods[mod], name)
        card_out = fn(*_sweep_args(torch, args, P15_DEVICE), **kw)
        cpu_out = fn(*_sweep_args(torch, args, "cpu"), **kw)
        worst = max(worst, _sweep_compare(torch, card_out, cpu_out,
                                          f"{mod}.{name}"))
        done.add(name)
    man = mods["manipulation"]
    for name, args, kw in (("fill_constant", ([2, 3], "int32", 7), {}),
                           ("full", ([2, 3], 1.5), {}),
                           ("zeros", ([2, 3],), {}), ("ones", ([3],), {}),
                           ("arange", (1, 7, 2), {}),
                           ("linspace", (0.0, 1.0, 5), {}),
                           ("eye", (2, 4), {})):
        _sweep_compare(torch, getattr(man, name)(*args, **kw,
                                                 device=P15_DEVICE),
                       getattr(man, name)(*args, **kw, device="cpu"), name)
        done.add(name)
    if man.is_empty(torch.zeros(0, device=P15_DEVICE)) is not True:
        raise AssertionError("is_empty")
    done.add("is_empty")
    x = torch.from_numpy(C.X.copy())
    for run in C.control_flow_runs():
        _sweep_compare(torch, run(mods["control_flow"], x.to(P15_DEVICE)),
                       run(mods["control_flow"], x), run.__name__)
    cf = mods["control_flow"]
    spec = torch.empty(3, 4, device="meta")
    _sweep_compare(torch, cf.py_func(lambda a: np.sin(a), x.to(P15_DEVICE), spec),
                   cf.py_func(lambda a: np.sin(a), x, spec), "py_func")
    _sweep_compare(torch, cf.print_op(x.to(P15_DEVICE), "phase 15 print_op: "), x,
                   "print_op")
    done |= C.CONTROL
    _sweep_compare(torch, C.tensor_array_run(mods["tensor_array"], x.to(P15_DEVICE),
                                             device=P15_DEVICE),
                   C.tensor_array_run(mods["tensor_array"], x,
                                      device="cpu"), "tensor_array")
    done |= set(mods["tensor_array"].__all__)
    rnd = mods["random_ops"]
    n = OPS_RANDOM_N
    moments = {}
    for name, args, kw, mean, std in C.RANDOM_MOMENTS:
        args = tuple(n if a == "n" else a for a in args)
        args = ([n],) if args == (n,) else args
        kw = {k: ([n] if v == "n" else v) for k, v in kw.items()}
        a = getattr(rnd, name)(*args, key=5, device=P15_DEVICE, **kw)
        b = getattr(rnd, name)(*args, key=5, device=P15_DEVICE, **kw)
        c = getattr(rnd, name)(*args, key=6, device=P15_DEVICE, **kw)
        cpu = getattr(rnd, name)(*args, key=5, device="cpu", **kw)
        m, s = float(a.double().mean()), float(a.double().std())
        se = std / np.sqrt(n)
        moments[name] = {"mean": m, "std": s, "want": [mean, std]}
        if not (a.device.type == P15_DEVICE and a.shape == cpu.shape and a.dtype == cpu.dtype
                and torch.equal(a, b) and not torch.equal(a, c)
                and abs(m - mean) <= OPS_MOMENT_SE * se
                and abs(s - std) <= OPS_MOMENT_SE * se * 1.5):
            raise AssertionError(f"random {name}: {moments[name]}")
    p = torch.full((n,), 0.3, device=P15_DEVICE)
    draws = {"bernoulli": rnd.bernoulli(p, key=1),
             "poisson": rnd.poisson(p * 0 + 4.0, key=1),
             "normal": rnd.normal(p * 0 + 1.0, 2.0, key=1),
             "multinomial": rnd.multinomial(torch.tensor(
                 [0.1, 0.2, 0.7], device=P15_DEVICE), n, replacement=True,
                 key=1).double(),
             "randperm": rnd.randperm(1000, key=1, device=P15_DEVICE)
             .sort().values.double(),
             "shuffle": rnd.shuffle(torch.arange(
                 1000, device=P15_DEVICE), key=1).sort().values.double(),
             "shuffle_batch": rnd.shuffle_batch(torch.arange(
                 1000, device=P15_DEVICE), key=1).sort().values.double()}
    want = {"bernoulli": (0.3, 0.458), "poisson": (4.0, 2.0),
            "normal": (1.0, 2.0), "multinomial": (1.6, 0.66),
            "randperm": (499.5, 288.8), "shuffle": (499.5, 288.8),
            "shuffle_batch": (499.5, 288.8)}
    for name, d in draws.items():
        m, s = float(d.double().mean()), float(d.double().std())
        moments[name] = {"mean": m, "std": s, "want": list(want[name])}
        if not (d.device.type == P15_DEVICE and abs(m - want[name][0]) <= 0.02 * want[name][1]
                * 10 and abs(s - want[name][1]) <= 0.05 * want[name][1]):
            raise AssertionError(f"random {name}: {moments[name]}")
    sl, sla = rnd.sample_logits(x.to(P15_DEVICE), torch.tensor([1, 3, 0],
                                                       device=P15_DEVICE), 5,
                                key=1)
    if sl.shape != (3, 6) or not torch.equal(sl[:, 0].cpu(), x[[0, 1, 2],
                                                               [1, 3, 0]]):
        raise AssertionError("random sample_logits")
    done |= C.RANDOM | {"uniform_random_batch_size_like",
                        "gaussian_random_batch_size_like"}
    u = ops.math.uniform_random_batch_size_like(x.to(P15_DEVICE), [1, 6], key=1)
    g = ops.math.gaussian_random_batch_size_like(x.to(P15_DEVICE), [1, 6], key=1)
    if u.shape != (3, 6) or u.device.type != P15_DEVICE \
            or g.device.type != P15_DEVICE:
        raise AssertionError("batch_size_like draws")
    missing = sorted(set().union(*(set(m.__all__) for m in mods.values()))
                     - done)
    if missing:
        raise AssertionError(f"ops sweep: not run on the card: {missing}")
    sweep_s = time.perf_counter() - t0
    # matmul_precision
    from paddle_tpu_torch import set_flags
    rng = np.random.default_rng(SEED + 18)
    mm, kk, nn_ = MATMUL_SHAPE
    a64 = torch.from_numpy(rng.standard_normal((mm, kk))).to(P15_DEVICE)
    b64 = torch.from_numpy(rng.standard_normal((kk, nn_))).to(P15_DEVICE)
    ref = a64 @ b64
    a32, b32 = a64.float(), b64.float()
    precision = {}
    for value in ("float32", "tensorfloat32"):
        set_flags({"matmul_precision": value})
        try:
            out = ops.matmul(a32, b32)
            err = float((out.double() - ref).abs().max()
                        / ref.abs().max())
            ms = device_ms(torch, lambda: ops.matmul(a32, b32))
        finally:
            set_flags({"matmul_precision": "default"})
        precision[value] = {"max_rel_err_vs_float64": err, "ms": ms,
                            "tflops": 2 * mm * kk * nn_ / ms / 1e9}
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("matmul_precision left TF32 on")
    res = {"cases": len(C.CASES), "functions": len(done),
           "max_rel_err_card_vs_cpu": worst, "bound": [OPS_RTOL, OPS_ATOL],
           "random_n": n, "random_moments": moments, "sweep_s": sweep_s,
           "matmul_shape": list(MATMUL_SHAPE),
           "matmul_precision": precision, "card": card}
    log(f"ops sweep [{card}]: {json.dumps(res)}")
    if not (precision["tensorfloat32"]["max_rel_err_vs_float64"]
            >= TF32_MIN_ERR
            and precision["float32"]["max_rel_err_vs_float64"]
            <= FP32_MAX_ERR):
        raise AssertionError(f"matmul_precision: {precision}")
    return res


def run_phase15(torch) -> tuple:
    """Phase 15. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    report["ernie_static_fit"], counts["ernie_static_fit"] = \
        ernie_static_fit(torch, card)
    report["ernie_to_static"], counts["ernie_to_static"] = \
        ernie_to_static(torch, card)
    report["program_run"] = program_run(torch, card)
    report["dy2static_cases"] = dy2static_cases(torch, card)
    report["ops_sweep"] = ops_sweep(torch, card)
    report["phase15_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {report['phase15_s']:.1f} s [{card}]")
    return report, counts



# ---------------------------------------------------------------------------
# phase 16: the recurrent and sequence stack (A17 part 2). (a) the PTB
# LSTM language model "large" (Zaremba, Sutskever & Vinyals 2014,
# arXiv:1409.2329 §4.1: 2 layers, hidden 1,500, vocabulary 10,000, 35
# unrolled steps, batch 20, dropout 0.65, untied, SGD at lr 1 with
# global-norm clipping at 10) on seeded Zipf ids through Model.fit,
# captured against eager bit for bit, one forward and backward against the
# CPU, and torch.nn.LSTM (cuDNN) as a yardstick; (b) CRNN-CTC trained with
# Adam under fused_adam, its CTC against torch's, its greedy decode and
# edit distance against the CPU; (c) the SRL BiLSTM-CRF and the sentiment
# BiLSTM on a ragged batch against the CPU; (d) the NCE skip-gram against
# the CPU and the row-sparse SGD and lazy Adam updates against the dense
# ones; (e) every public function of the five new op modules and the CTC
# losses on the card against the CPU. `python3 chip_smoke.py --recurrent`
# runs this phase alone.
# ---------------------------------------------------------------------------

# where phase 16 runs (a CPU rehearsal sets "cpu" and shrinks the configs)
P16_DEVICE = "cuda"
PTB_CFG = dict(vocab_size=10000, hidden_size=1500, num_layers=2,
               dropout=0.65, tie_weights=False)
PTB_BATCH, PTB_T, PTB_STEPS = 20, 35, 8
PTB_LR, PTB_CLIP = 1.0, 10.0
# the exponent of the seeded Zipf token ids
PTB_ZIPF_A = 1.1
# card against CPU at full width and dropout 0, one forward and backward
# (fp32, TF32 off): 35 recurrent steps of [20, 1500] x [1500, 6000] sums
# on both sides, cuBLAS against the CPU's BLAS. The loss's relative gap,
# and each leaf's largest gradient gap over that leaf's largest entry
PTB_LOSS_TOL, PTB_GRAD_TOL = 1e-5, 1e-4
# cuDNN's LSTM (the port's weights transposed) against the port's stack:
# largest output gap over the largest output
PTB_CUDNN_TOL = 1e-4
CRNN_CFG = dict(num_classes=95, height=32, base=64, rnn_hidden=256)
CRNN_BATCH, CRNN_W, CRNN_STEPS = 64, 256, 6
CRNN_LABEL_LEN = (8, 24)
# the port's CTC ("mean") against torch.nn.functional.ctc_loss's per
# sequence losses reduced the same way: relative gap (64 frames of fp32
# log-space sums on both)
CTC_TOL = 1e-5
SRL_CFG = dict(vocab_size=20000, num_tags=59, embed_dim=32, hidden=512,
               num_layers=2)
SENT_CFG = dict(vocab_size=20000, embed_dim=32, hidden=512, num_layers=2)
SRL_BATCH, SRL_LEN = 32, (8, 64)
# card against CPU through a 2-layer BiLSTM over 64 steps and the CRF's
# 64-step log-sum-exp recursion: loss relative gap; each leaf's largest
# gradient gap over its largest entry; the sentiment logits' largest gap
# over the largest logit; two Viterbi paths whose scores differ by less
# than SRL_TIE_TOL of the score are a tie (rounding may order them)
SRL_LOSS_TOL, SRL_GRAD_TOL, SENT_TOL, SRL_TIE_TOL = 1e-5, 1e-4, 1e-5, 1e-5
# Mikolov et al. 2013's skip-gram: vocabulary 100,000, 300 dims, 5
# negatives; batch 1024
W2V_CFG = dict(vocab_size=100000, embed_dim=300, num_neg=5)
W2V_BATCH = 1024
# NCE loss and gradients card against CPU (one gather and a 300-dim dot
# product a logit): relative gaps
W2V_TOL = 1e-5
# the PTB path runs no kernel of the port (cuBLAS products, plain PyTorch
# around them); the CRNN path's Adam is the leaf kernel, once a step
PATH_KERNELS.update({"ptb_lm_large_fit": (), "crnn_ctc_fit": ("adam_leaf",)})


def p16_zipf(rng, shape, vocab: int):
    """Seeded Zipf token ids in [0, vocab)."""
    return (np.minimum(rng.zipf(PTB_ZIPF_A, shape), vocab) - 1).astype(
        np.int64)


def ptb_batches(torch, n: int, seed: int) -> list:
    """``n`` (ids, next ids) batches of PTB_BATCH x PTB_T on the CPU."""
    rng = np.random.default_rng(seed)
    ids = p16_zipf(rng, (n * PTB_BATCH, PTB_T + 1), PTB_CFG["vocab_size"])
    return [(torch.from_numpy(ids[i * PTB_BATCH:(i + 1) * PTB_BATCH, :-1]),
             torch.from_numpy(ids[i * PTB_BATCH:(i + 1) * PTB_BATCH, 1:]))
            for i in range(n)]


def ptb_model(torch, device: str, dropout: float):
    from paddle_tpu_torch.models import LMConfig, LSTMLanguageModel
    return LSTMLanguageModel(LMConfig(**dict(PTB_CFG, dropout=dropout)),
                             device=device, seed=SEED)


def ptb_loss(out, label):
    from paddle_tpu_torch.ops.loss import cross_entropy
    return cross_entropy(out, label)


def ptb_optimizer():
    from paddle_tpu_torch.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    return SGD(PTB_LR, grad_clip=ClipGradByGlobalNorm(PTB_CLIP))


def p16_grads(torch, model, loss_fn) -> tuple:
    """(loss, {name: grad}) of one forward and backward."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


def cpu_twin(torch, model, make):
    """``make("cpu")`` with ``model``'s state copied in."""
    twin = make("cpu")
    twin.load_state_dict({k: v.detach().cpu()
                          for k, v in model.state_dict().items()})
    return twin


def ptb_card_against_cpu(torch, batch) -> dict:
    """One forward and backward at full width, dropout 0, on the card and
    on the CPU from the same weights; then cuDNN's LSTM on the same
    weights and input as a yardstick."""
    card = ptb_model(torch, P16_DEVICE, 0.0)
    cpu = cpu_twin(torch, card, lambda d: ptb_model(torch, d, 0.0))
    x, y = batch
    t0 = time.perf_counter()
    lc, gc = p16_grads(torch, card, lambda m: ptb_loss(
        m(x.to(P16_DEVICE)), y.to(P16_DEVICE)))
    lh, gh = p16_grads(torch, cpu, lambda m: ptb_loss(m(x), y))
    cpu_s = time.perf_counter() - t0
    gaps = grad_gaps(torch, gc, gh)
    res = {"loss_card": lc, "loss_cpu": lh,
           "loss_rel_gap": abs(lc - lh) / abs(lh),
           "grad_rel_gap_max": max(gaps.values()),
           "grad_rel_gap_worst_leaf": max(gaps, key=gaps.get),
           "bounds": {"loss": PTB_LOSS_TOL, "grad": PTB_GRAD_TOL},
           "cpu_threads": torch.get_num_threads(), "both_s": cpu_s}
    del cpu
    # the yardstick: torch.nn.LSTM with the port's gates transposed
    hid, layers = PTB_CFG["hidden_size"], PTB_CFG["num_layers"]
    ref = torch.nn.LSTM(hid, hid, num_layers=layers, batch_first=True,
                        device=P16_DEVICE)
    with torch.no_grad():
        for k in range(layers):
            cell = card.lstm.fw[k].cell
            getattr(ref, f"weight_ih_l{k}").copy_(cell.weight_ih.T)
            getattr(ref, f"weight_hh_l{k}").copy_(cell.weight_hh.T)
            getattr(ref, f"bias_ih_l{k}").copy_(cell.bias_ih)
            getattr(ref, f"bias_hh_l{k}").copy_(cell.bias_hh)
        h = card.embed(x.to(P16_DEVICE)).detach()
        ours, _ = card.lstm(h)
        theirs, _ = ref(h)
    res["cudnn_out_rel_gap"] = float((ours - theirs).abs().max()
                                     / ours.abs().max())
    res["cudnn_bound"] = PTB_CUDNN_TOL
    if P16_DEVICE == "cuda":
        hg = h.clone().requires_grad_(True)
        dout = torch.randn_like(ours)

        def fwd_bwd(layer):
            def run():
                out, _ = layer(hg)
                out.backward(dout)
            return run

        res["port_lstm_fwd_bwd_ms"] = device_ms(torch, fwd_bwd(card.lstm))
        res["cudnn_lstm_fwd_bwd_ms"] = device_ms(torch, fwd_bwd(ref))
        with torch.no_grad():
            res["port_lstm_fwd_ms"] = device_ms(torch,
                                                lambda: card.lstm(h))
            res["cudnn_lstm_fwd_ms"] = device_ms(torch, lambda: ref(h))
    return res


def ptb_lm_large_fit(torch, card: str) -> tuple:
    """(a): PTB_STEPS captured steps through Model.fit, the same steps
    eager, and the card against the CPU."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.static import TrainStep
    batches = ptb_batches(torch, PTB_STEPS, SEED + 160)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = ptb_model(torch, P16_DEVICE, PTB_CFG["dropout"])
    n_params = sum(p.numel() for p in net.parameters())
    model = Model(net, loss=ptb_loss, optimizer=ptb_optimizer())
    rec = hapi_recorder(torch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(batches, epochs=1, callbacks=[rec], verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in rec.losses]
    step = model._train_step
    captures, capture_ms = step.captures, step.capture_ms
    # two profiled replays: device ms, busy share, the largest kernels
    busy = rn_busy(torch, step, tuple(t.to(P16_DEVICE)
                                      for t in batches[0])) \
        if P16_DEVICE == "cuda" else None
    # the stream ms of steps 3..PTB_STEPS (events after each step)
    ms = [rec.events[k - 2].elapsed_time(rec.events[k - 1])
          for k in range(3, PTB_STEPS + 1)] if rec.events else []
    step_ms = float(np.median(ms)) if ms else None
    del model, step, net
    torch.cuda.empty_cache()
    # the same steps eager, from the same weights and seed
    eager = TrainStep(ptb_model(torch, P16_DEVICE, PTB_CFG["dropout"]),
                      ptb_optimizer(), ptb_loss, compiled=False)
    eager_losses = [float(eager(x.to(P16_DEVICE),
                                labels=(y.to(P16_DEVICE),))["loss"])
                    for x, y in batches]
    del eager
    torch.cuda.empty_cache()
    against_cpu = ptb_card_against_cpu(torch, batches[0])
    tokens = PTB_BATCH * PTB_T
    res = {"config": PTB_CFG, "parameters": n_params, "batch": PTB_BATCH,
           "unrolled": PTB_T, "steps": PTB_STEPS,
           "optimizer": f"SGD({PTB_LR}) + ClipGradByGlobalNorm({PTB_CLIP})",
           "input_projection": "hoisted: one [B*T, in] x [in, 4H] product "
                               "a layer, then one [B, H] x [H, 4H] a step",
           "losses": losses, "eager_losses": eager_losses,
           "captured_equals_eager": losses == eager_losses,
           "captures": captures, "capture_ms": capture_ms,
           "step_stream_ms": ms, "step_ms_median_3_to_8": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3 if step_ms else None,
           "peak_allocated_gb": peak, "fit_s": fit_s,
           "launches": nonzero(counts), "profiled_replays": busy,
           "card_against_cpu": against_cpu, "card": card}
    log(f"ptb lm large fit [{card}]: {json.dumps(res)}")
    if len(losses) != PTB_STEPS or not all(np.isfinite(losses)) \
            or losses != eager_losses or nonzero(counts) \
            or (P16_DEVICE == "cuda" and captures != 1):
        raise AssertionError(f"ptb fit: {res}")
    if against_cpu["loss_rel_gap"] > PTB_LOSS_TOL \
            or against_cpu["grad_rel_gap_max"] > PTB_GRAD_TOL \
            or against_cpu["cudnn_out_rel_gap"] > PTB_CUDNN_TOL:
        raise AssertionError(f"ptb card against cpu: {against_cpu}")
    return res, counts


def crnn_batches(torch, n: int, seed: int) -> list:
    """``n`` (images, labels, label_lengths) batches on the CPU: standard
    normal images, labels of CRNN_LABEL_LEN characters (0-padded)."""
    rng = np.random.default_rng(seed)
    lo, hi = CRNN_LABEL_LEN
    out = []
    for _ in range(n):
        img = rng.standard_normal((CRNN_BATCH, 1, CRNN_CFG["height"],
                                   CRNN_W)).astype(np.float32)
        lens = rng.integers(lo, hi + 1, CRNN_BATCH)
        lab = rng.integers(0, CRNN_CFG["num_classes"], (CRNN_BATCH, hi))
        lab[np.arange(hi)[None, :] >= lens[:, None]] = 0
        out.append(tuple(torch.from_numpy(a) for a in (img, lab, lens)))
    return out


def crnn_loss(logits, labels, label_lengths):
    import torch
    from paddle_tpu_torch.ops.loss import ctc_loss
    t = logits.shape[1]
    lp = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    in_len = torch.full((logits.shape[0],), t, dtype=torch.int64,
                        device=logits.device)
    return ctc_loss(lp, labels, in_len, label_lengths,
                    blank=CRNN_CFG["num_classes"])


def crnn_ctc_fit(torch, card: str) -> tuple:
    """(b): CRNN_STEPS captured steps with Adam under fused_adam (the
    leaf kernel once a step); the CTC loss against torch's; decoding and
    edit distance on the card against the CPU."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import CRNNCTC
    from paddle_tpu_torch.ops.loss import ctc_loss
    from paddle_tpu_torch.ops.sequence import (ctc_greedy_decoder,
                                               edit_distance)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import TrainStep
    batches = [tuple(t.to(P16_DEVICE) for t in b)
               for b in crnn_batches(torch, CRNN_STEPS, SEED + 161)]
    restore = flag_scope({"fused_adam": True})
    try:
        net = CRNNCTC(**CRNN_CFG, device=P16_DEVICE, seed=SEED)
        step = TrainStep(net, Adam(1e-3), crnn_loss, seed=SEED)
        kernels.reset_launch_counts()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(CRNN_STEPS + 1)] \
            if P16_DEVICE == "cuda" else []
        if marks:
            marks[0].record()
        losses = []
        for k, (img, lab, lens) in enumerate(batches):
            losses.append(step(img, labels=(lab, lens))["loss"])
            if marks:
                marks[k + 1].record()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        losses = [float(v) for v in losses]
        ms = [marks[k].elapsed_time(marks[k + 1])
              for k in range(CRNN_STEPS)] if marks else []
        captures = step.captures
    finally:
        restore()
    # the CTC check on the trained model's logits (feasible labels: at
    # most 2 x 24 + 1 of the 64 frames)
    img, lab, lens = batches[0]
    net.eval()
    with torch.no_grad():
        logits = net(img)
    t = logits.shape[1]
    lp = torch.log_softmax(logits, dim=-1).transpose(0, 1).contiguous()
    in_len = torch.full((CRNN_BATCH,), t, dtype=torch.int64,
                        device=lp.device)
    blank = CRNN_CFG["num_classes"]
    ours = float(ctc_loss(lp, lab, in_len, lens, blank=blank))
    per = torch.nn.functional.ctc_loss(lp, lab, in_len, lens, blank=blank,
                                       reduction="none")
    theirs = float((per / lens.clamp(min=1)).mean())
    ctc = {"port": ours, "torch": theirs,
           "rel_gap": abs(ours - theirs) / abs(theirs), "bound": CTC_TOL}
    if P16_DEVICE == "cuda":
        lpg = lp.clone().requires_grad_(True)

        def run(fn):
            def go():
                fn(lpg).backward()
            return go

        ctc["port_fwd_bwd_ms"] = device_ms(torch, run(
            lambda x: ctc_loss(x, lab, in_len, lens, blank=blank)))
        ctc["torch_fwd_bwd_ms"] = device_ms(torch, run(
            lambda x: (torch.nn.functional.ctc_loss(
                x, lab, in_len, lens, blank=blank, reduction="none")
                / lens.clamp(min=1)).mean()))
    # decoding: the same logits on the card and on the CPU. Six steps in,
    # the trained model's argmax is the blank at every frame, so the
    # logits are an untrained twin's (seed + 1), whose argmax spreads
    fresh = CRNNCTC(**CRNN_CFG, device=P16_DEVICE, seed=SEED + 1).eval()
    with torch.no_grad():
        lsm = torch.log_softmax(fresh(img), dim=-1)
    del fresh
    dec, n = ctc_greedy_decoder(lsm, in_len, blank=blank)
    dec_c, n_c = ctc_greedy_decoder(lsm.cpu(), in_len.cpu(), blank=blank)
    dist, _ = edit_distance(dec, n, lab, lens)
    dist_c, _ = edit_distance(dec_c, n_c, lab.cpu(), lens.cpu())
    decode = {"equal": bool(torch.equal(dec.cpu(), dec_c)
                            and torch.equal(n.cpu(), n_c)),
              "edit_distance_equal": bool(torch.equal(dist.cpu(), dist_c)),
              "mean_normalised_edit_distance": float(dist_c.mean()),
              "decoded_len_mean": float(n_c.double().mean())}
    per_step = {k: 0 for k in counts}
    per_step["adam_leaf"] = 1
    res = {"config": CRNN_CFG, "batch": CRNN_BATCH, "width": CRNN_W,
           "frames": t, "steps": CRNN_STEPS, "optimizer": "Adam(1e-3)",
           "flags": {"fused_adam": True}, "losses": losses,
           "captures": captures, "step_stream_ms": ms,
           "step_ms_median": float(np.median(ms[1:])) if ms else None,
           "launches": nonzero(counts), "ctc": ctc, "decode": decode,
           "card": card}
    log(f"crnn ctc fit [{card}]: {json.dumps(res)}")
    del step, net
    if not all(np.isfinite(losses)) or ctc["rel_gap"] > CTC_TOL \
            or not decode["equal"] or not decode["edit_distance_equal"] \
            or (P16_DEVICE == "cuda" and captures != 1):
        raise AssertionError(f"crnn: {res}")
    path_launches("crnn_ctc_fit", counts, per_step
                  if P16_DEVICE == "cuda" else {k: 0 for k in counts},
                  CRNN_STEPS)
    return res, counts


def srl_batch(torch, seed: int) -> tuple:
    """(words, predicate marks, tags, lengths): SRL_BATCH rows of ragged
    lengths in SRL_LEN, ids from 1 (0 pads), zero past each length."""
    rng = np.random.default_rng(seed)
    lo, hi = SRL_LEN
    lens = rng.integers(lo, hi + 1, SRL_BATCH)
    valid = np.arange(hi)[None, :] < lens[:, None]
    words = p16_zipf(rng, (SRL_BATCH, hi), SRL_CFG["vocab_size"] - 1) + 1
    mark = rng.integers(0, 2, (SRL_BATCH, hi))
    tags = rng.integers(0, SRL_CFG["num_tags"], (SRL_BATCH, hi))
    return tuple(torch.from_numpy(np.where(valid, a, 0))
                 for a in (words, mark, tags)) + (torch.from_numpy(lens),)


def srl_crf(torch, card: str) -> dict:
    """(c): the SRL BiLSTM-CRF and the sentiment BiLSTM, card against
    CPU."""
    from paddle_tpu_torch.models import SentimentBiLSTM, SRLBiLSTMCRF
    from paddle_tpu_torch.ops.crf import (chunk_eval, crf_decoding,
                                          linear_chain_crf)
    batch = srl_batch(torch, SEED + 162)
    words, mark, tags, lens = batch

    def make(d):
        return SRLBiLSTMCRF(**SRL_CFG, device=d, seed=SEED)

    card_m = make(P16_DEVICE)
    with torch.no_grad():  # a seeded transition (JAX starts it at zero)
        card_m.transition.copy_(torch.from_numpy(
            np.random.default_rng(SEED + 163).normal(
                0, 0.1, tuple(card_m.transition.shape)).astype(np.float32)))
    cpu_m = cpu_twin(torch, card_m, make)
    dev_b = tuple(t.to(P16_DEVICE) for t in batch)
    lc, gc = p16_grads(torch, card_m, lambda m: m.loss(*dev_b))
    lh, gh = p16_grads(torch, cpu_m, lambda m: m.loss(*batch))
    gaps = grad_gaps(torch, gc, gh)
    with torch.no_grad():
        em_c = card_m.emissions(dev_b[0], dev_b[1], dev_b[3])
        em_h = cpu_m.emissions(words, mark, lens)
        path_c = crf_decoding(em_c, card_m.transition, dev_b[3]).cpu()
        path_h = crf_decoding(em_h, cpu_m.transition, lens)
        # rows whose paths differ: a tie when both paths score within
        # SRL_TIE_TOL under the CPU's emissions
        differ = (path_c != path_h).any(dim=1)
        ties = 0
        if bool(differ.any()):
            nll_c = linear_chain_crf(em_h, cpu_m.transition, path_c, lens)
            nll_h = linear_chain_crf(em_h, cpu_m.transition, path_h, lens)
            gap = ((nll_c - nll_h).abs() / nll_h.abs().clamp(min=1.0))
            if bool((gap[differ] > SRL_TIE_TOL).any()):
                raise AssertionError(f"srl: decoded paths differ beyond a "
                                     f"tie: {gap[differ].tolist()}")
            ties = int(differ.sum())
        n_types = (SRL_CFG["num_tags"] - 1) // 2
        ck_c = chunk_eval(path_h.to(P16_DEVICE), dev_b[2], dev_b[3],
                          n_types)
        ck_h = chunk_eval(path_h, tags, lens, n_types)
        chunks_equal = all(torch.equal(ck_c[k].cpu(), ck_h[k])
                           for k in ("num_infer_chunks", "num_label_chunks",
                                     "num_correct_chunks"))
    # the sentiment BiLSTM on the same ragged batch (0 pads)
    sent = SentimentBiLSTM(**SENT_CFG, device=P16_DEVICE, seed=SEED)
    sent_h = cpu_twin(torch, sent, lambda d: SentimentBiLSTM(
        **SENT_CFG, device=d, seed=SEED))
    with torch.no_grad():
        lo_c = sent(dev_b[0]).cpu()
        lo_h = sent_h(words)
    sent_gap = float((lo_c - lo_h).abs().max() / lo_h.abs().max())
    res = {"config": SRL_CFG, "batch": SRL_BATCH, "lengths": SRL_LEN,
           "loss_card": lc, "loss_cpu": lh,
           "loss_rel_gap": abs(lc - lh) / abs(lh),
           "grad_rel_gap_max": max(gaps.values()),
           "grad_rel_gap_worst_leaf": max(gaps, key=gaps.get),
           "decode_rows_differing_as_ties": ties,
           "chunk_counts": {k: int(ck_h[k]) for k in (
               "num_infer_chunks", "num_label_chunks",
               "num_correct_chunks")}, "chunk_counts_equal": chunks_equal,
           "sentiment_config": SENT_CFG, "sentiment_logit_rel_gap": sent_gap,
           "bounds": {"loss": SRL_LOSS_TOL, "grad": SRL_GRAD_TOL,
                      "sentiment": SENT_TOL, "tie": SRL_TIE_TOL},
           "card": card}
    log(f"srl crf [{card}]: {json.dumps(res)}")
    if res["loss_rel_gap"] > SRL_LOSS_TOL \
            or res["grad_rel_gap_max"] > SRL_GRAD_TOL \
            or sent_gap > SENT_TOL or not chunks_equal:
        raise AssertionError(f"srl: {res}")
    return res


def word2vec_sparse(torch, card: str) -> dict:
    """(d): the NCE skip-gram card against CPU, its sampled path, and the
    row-sparse SGD and lazy Adam updates against the dense ones."""
    from paddle_tpu_torch.models import SkipGramNCE
    from paddle_tpu_torch.ops import sampling, sparse
    from paddle_tpu_torch.optimizer import SGD, Adam
    rng = np.random.default_rng(SEED + 164)
    v, d, k = W2V_CFG["vocab_size"], W2V_CFG["embed_dim"], W2V_CFG["num_neg"]
    center = torch.from_numpy(p16_zipf(rng, (W2V_BATCH,), v))
    context = torch.from_numpy(p16_zipf(rng, (W2V_BATCH,), v))
    neg = torch.from_numpy(p16_zipf(rng, (W2V_BATCH, k), v))

    def make(dev):
        return SkipGramNCE(**W2V_CFG, device=dev, seed=SEED)

    card_m = make(P16_DEVICE)
    with torch.no_grad():  # a seeded output table (JAX starts it at zero)
        card_m.out_weight.copy_(torch.from_numpy(rng.normal(
            0, 0.1, (v, d)).astype(np.float32)))
    cpu_m = cpu_twin(torch, card_m, make)
    dev = [t.to(P16_DEVICE) for t in (center, context, neg)]

    def given_neg_loss(m, c, ctx, n):  # the model's loss, on given negatives
        return torch.mean(sampling.nce_loss(
            m.in_embed(c), m.out_weight, ctx, v, k, sampler="log_uniform",
            custom_neg_samples=n))

    lc, gc = p16_grads(torch, card_m, lambda m: given_neg_loss(m, *dev))
    lh, gh = p16_grads(torch, cpu_m, lambda m: given_neg_loss(
        m, center, context, neg))
    gaps = grad_gaps(torch, gc, gh)
    # the sampled path: the same draw again from the same seed
    x = card_m.in_embed(dev[0]).detach()
    s1 = sampling.nce_loss(x, card_m.out_weight.detach(), dev[1], v, k,
                           sampler="log_uniform", key=SEED)
    s2 = sampling.nce_loss(x, card_m.out_weight.detach(), dev[1], v, k,
                           sampler="log_uniform", key=SEED)
    stream = card_m.loss(dev[0], dev[1]).detach()
    sampled = {"shape": list(s1.shape), "device": str(s1.device),
               "same_draw_same_seed": bool(torch.equal(s1, s2)),
               "finite": bool(torch.isfinite(s1).all()),
               "stream_loss": float(stream)}
    # the embedding's gradient as a RowSlices, merged once
    emb = card_m.in_embed(dev[0]).detach().requires_grad_(True)
    loss = torch.mean(sampling.nce_loss(
        emb, card_m.out_weight.detach(), dev[1], v, k,
        sampler="log_uniform", custom_neg_samples=dev[2]))
    (g_out,) = torch.autograd.grad(loss, emb)
    g = sparse.merge_rows(sparse.embedding_grad(dev[0], g_out, v))
    dense_g = sparse.to_dense(g)
    table = card_m.in_embed.weight.detach()
    touched = torch.zeros(v, dtype=torch.bool, device=table.device)
    touched[dev[0]] = True
    updates = {}
    for name, make_opt, make_dense in (
            ("sgd", lambda: SGD(0.5), lambda: SGD(0.5)),
            ("adam_lazy", lambda: Adam(1e-2, lazy_mode=True),
             lambda: Adam(1e-2))):
        sp, dn = table.clone(), table.clone()
        opt_s, opt_d = make_opt(), make_dense()
        st_s, st_d = opt_s.init({"w": sp}), opt_d.init({"w": dn})
        opt_s.apply_gradients({"w": sp}, {"w": g}, st_s)
        opt_d.apply_gradients({"w": dn}, {"w": dense_g}, st_d)
        ok = bool(torch.equal(sp[touched], dn[touched])) \
            and bool(torch.equal(sp[~touched], table[~touched]))
        for slot, t in st_s["slots"]["w"].items():
            ok = ok and bool(torch.equal(t[touched],
                                         st_d["slots"]["w"][slot][touched]))
            ok = ok and not bool(t[~touched].any())
        u = {"equal_on_touched_rows_and_others_unchanged": ok,
             "touched_rows": int(touched.sum())}
        if P16_DEVICE == "cuda":
            u["sparse_ms"] = device_ms(torch, lambda: opt_s.apply_gradients(
                {"w": sp}, {"w": g}, st_s))
            u["dense_ms"] = device_ms(torch, lambda: opt_d.apply_gradients(
                {"w": dn}, {"w": dense_g}, st_d))
        updates[name] = u
    res = {"config": W2V_CFG, "batch": W2V_BATCH, "loss_card": lc,
           "loss_cpu": lh, "loss_rel_gap": abs(lc - lh) / abs(lh),
           "grad_rel_gap_max": max(gaps.values()), "grad_rel_gaps": gaps,
           "bound": W2V_TOL, "sampled": sampled, "updates": updates,
           "card": card}
    log(f"word2vec sparse [{card}]: {json.dumps(res)}")
    if res["loss_rel_gap"] > W2V_TOL or res["grad_rel_gap_max"] > W2V_TOL \
            or not (sampled["same_draw_same_seed"] and sampled["finite"]
                    and sampled["shape"] == [W2V_BATCH]
                    and s1.device.type == P16_DEVICE) \
            or not all(u["equal_on_touched_rows_and_others_unchanged"]
                       for u in updates.values()):
        raise AssertionError(f"word2vec: {res}")
    return res


def ops_sweep_recurrent(torch, card: str) -> dict:
    """(e): every public function of sequence, crf, rnn_functional,
    sampling and sparse, and the CTC losses, on the card against the
    CPU; the sampled ones by shape, device and the same draw again."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.testing import op_cases as C
    mods = {m: getattr(ops, m) for m in C.SEQ_MODULES + ("loss",)}
    t0 = time.perf_counter()
    worst, done = 0.0, set()
    for mod, name, args, kw in C.SEQ_CASES:
        fn = getattr(mods[mod], name)

        def call(dev):
            return fn(*_sweep_args(torch, args, dev),
                      **_sweep_arg(torch, kw, dev))

        worst = max(worst, _sweep_compare(torch, call(P16_DEVICE),
                                          call("cpu"), f"{mod}.{name}",
                                          P16_DEVICE))
        done.add(name)
    for run in C.sparse_runs():
        worst = max(worst, _sweep_compare(
            torch, run(mods["sparse"], lambda a: _sweep_arg(
                torch, a, P16_DEVICE)),
            run(mods["sparse"], lambda a: _sweep_arg(torch, a, "cpu")),
            run.__name__, P16_DEVICE))
        done.add(run.__name__)
    done.add("RowSlices")
    x = torch.from_numpy(C.F2).to(P16_DEVICE)
    w = torch.from_numpy(C.NCE_W).to(P16_DEVICE)
    lab = torch.tensor([2, 7, 10], device=P16_DEVICE)
    draws = [mods["sampling"].sampled_softmax_with_cross_entropy(
        x, w, lab, 11, 6, key=key) for key in (4, 4, 5)]
    if not (draws[0].shape == (3,) and draws[0].device.type == P16_DEVICE
            and torch.equal(draws[0], draws[1])
            and not torch.equal(draws[0], draws[2])
            and bool(torch.isfinite(draws[0]).all())):
        raise AssertionError(f"sampled softmax: {draws}")
    done |= C.SEQ_RANDOM
    missing = sorted(set().union(*(set(mods[m].__all__)
                                   for m in C.SEQ_MODULES))
                     - done) + sorted({"ctc_loss", "warpctc"} - done)
    if missing:
        raise AssertionError(f"recurrent ops sweep: not run on the card: "
                             f"{missing}")
    res = {"cases": len(C.SEQ_CASES) + len(C.sparse_runs()),
           "functions": len(done), "max_rel_err_card_vs_cpu": worst,
           "bound": [OPS_RTOL, OPS_ATOL],
           "sweep_s": time.perf_counter() - t0, "card": card}
    log(f"recurrent ops sweep [{card}]: {json.dumps(res)}")
    return res


def run_phase16(torch) -> tuple:
    """Phase 16. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts = {}, {}
    report["ptb_lm_large_fit"], counts["ptb_lm_large_fit"] = \
        ptb_lm_large_fit(torch, card)
    torch.cuda.empty_cache()
    report["crnn_ctc_fit"], counts["crnn_ctc_fit"] = crnn_ctc_fit(torch,
                                                                  card)
    torch.cuda.empty_cache()
    report["srl_crf"] = srl_crf(torch, card)
    torch.cuda.empty_cache()
    report["word2vec_sparse"] = word2vec_sparse(torch, card)
    torch.cuda.empty_cache()
    report["ops_sweep_recurrent"] = ops_sweep_recurrent(torch, card)
    report["phase16_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {report['phase16_s']:.1f} s [{card}]")
    return report, counts


# ---------------------------------------------------------------------------
# Phase 17: the vision slice. (a) MobileNetV2 1.0 at 224, NHWC, bf16 with
# fp32 masters, b128 through Model.fit with Adam under fused_adam (row 11
# once a step), captured, its losses bit for bit with the eager steps
# (deterministic convolutions on both), the device split of a profiled
# replay, then card against CPU in fp32 at batch 4 (ReLU6 decisions
# shared); (b) SSDLite at its defaults, b32: loss card against CPU, 4
# captured training steps, predict card against CPU (the CPU's NMS taking
# the card's choices where scores tie within rounding); (c) the DCGAN step
# 8 times, its first step against the CPU on the same z; (d) VGG-16-BN,
# MobileNetV1 and LeNet forward and backward, card against CPU; (e) the
# vision and detection op cases on the card against the CPU.
# `python3 chip_smoke.py --vision` runs this phase alone.
# ---------------------------------------------------------------------------

# where phase 17 runs (a CPU rehearsal sets "cpu")
P17_DEVICE = "cuda"
MV2_BATCH, MV2_HW, MV2_CLASSES, MV2_STEPS = 128, 224, 1000, 8
MV2_LR = 1e-3
# card against CPU (fp32, TF32 off, two-pass statistics, ReLU6 decisions
# shared): the loss's relative gap, and each leaf's largest gradient gap
# over that leaf's largest entry (a convolution bias-free net, so no leaf
# is zero but for rounding)
MV2_CPU_BATCH = 4
P17_LOSS_TOL, P17_GRAD_TOL = 1e-5, 1e-4
# fp32 gradients: each leaf's card gap to float64 within this many times
# the CPU's fp32 gap (a nearly cancelled leaf's rounding, of one size on
# both devices) where that exceeds P17_GRAD_TOL; a leaf over it passes
# only where cuDNN's Winograd weight gradient explains it, within
# P17_WINOGRAD_TOL (``p17_winograd``)
P17_NOISE_K, P17_WINOGRAD_TOL = 4.0, 2e-3
SSD_CFG = dict(num_classes=20, image_size=128, base=32)
SSD_BATCH, SSD_STEPS, SSD_GT = 32, 4, 6
# predict: keep_top_k rows an image, and a threshold the random-weight
# model's softmax scores (~1 / 21) reach
SSD_TOP_K, SSD_SCORE = 20, 0.04
# a score within this of the card's choice is a tie the CPU may break
# the other way (fp32 softmax over 21 logits on both sides)
SSD_TIE = 1e-5
GAN_CFG = dict(z_dim=64, base=32)
GAN_BATCH, GAN_STEPS, GAN_LR = 64, 8, 0.05
VGG_BATCH, MV1_BATCH, LENET_BATCH = 2, 4, 16
PATH_KERNELS.update({"mv2_fit": ("adam_leaf",)})


def p17_images(torch, n: int, hw: int, seed: int, c: int = 3,
               nhwc: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, hw, hw), dtype=np.float32)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return torch.from_numpy(x)


def zero_grad_leaves(model) -> dict:
    """``{leaf: reference leaf}`` for the shifts whose exact gradient is
    zero, each measured against a sibling's gradient scale instead (as
    ``grad_gaps`` measures a key-projection bias): a convolution bias
    followed by a training-mode BatchNorm (the norm removes any
    per-channel constant), and MobileNetV2's projection BatchNorm shift
    (the linear bottleneck: the stream it adds to reaches only 1x1
    convolutions followed by training-mode BatchNorms, which remove it).
    Their entries on either side are rounding, so their own scale would
    compare noise with noise."""
    from paddle_tpu_torch.models.mobilenet import _InvertedResidual
    from paddle_tpu_torch.nn import Conv2D
    from paddle_tpu_torch.nn.norm import _BatchNormBase
    out = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        kids = list(mod.named_children())
        for (a, first), (_, second) in zip(kids, kids[1:]):
            if isinstance(first, Conv2D) and first.bias is not None \
                    and isinstance(second, _BatchNormBase):
                out[f"{pre}{a}.bias"] = f"{pre}{a}.weight"
        if isinstance(mod, _InvertedResidual):
            last = str(len(mod.conv) - 1)
            out[f"{pre}conv.{last}.bias"] = f"{pre}conv.{last}.weight"
    return out


def p17_gaps(torch, grads: dict, ref: dict, zero: dict) -> dict:
    """``grad_gaps``, the leaves of ``zero`` measured against their
    reference leaf's largest entry."""
    out = {}
    for n, g in grads.items():
        scale = float(ref[zero.get(n, n)].abs().max())
        out[n] = float((g.cpu() - ref[n]).abs().max()) / max(scale, 1e-30)
    return out


def p17_card_against_cpu(torch, tag: str, make, x, loss_fn) -> dict:
    """One training-mode forward and backward of ``make(device)`` (two-pass
    statistics) on the card and on the CPU from the same weights and
    buffers, the ReLU/ReLU6 decisions of the card's fp32 run shared by
    every other run (``ReluSigns``).

    In fp32: the loss within P17_LOSS_TOL relative, and each leaf's card
    gradient within max(P17_GRAD_TOL, P17_NOISE_K x the CPU's fp32 gap) of
    a float64 CPU run (gaps over the leaf's largest float64 entry,
    ``zero_grad_leaves`` against a sibling's). The CPU's term admits the
    leaves whose exact gradient is nearly cancelled, where fp32 itself
    strays on either device (a BatchNorm scale with a zero shift feeding a
    ReLU6, a depthwise convolution and another BatchNorm: only the clipped
    units keep its gradient from cancelling); a gap the card alone shows
    fails. A leaf over that bound passes only where cuDNN's Winograd
    weight gradient explains it (``p17_winograd``). In float64 on both
    devices: the loss within P17_LOSS_TOL relative and each leaf's
    gradient within P17_GRAD_TOL, the card running the same composition
    and its libraries' float64 kernels."""
    card = make(P17_DEVICE)
    cpu = cpu_twin(torch, card, make)
    start = {k: v.detach().cpu().clone() for k, v in card.state_dict().items()}
    restore = flag_scope({"batch_norm_single_pass": False})
    signs = ReluSigns(torch)

    def run(model, dev, how, dtype):
        model.load_state_dict({k: v.to(dev) for k, v in start.items()})
        model.to(dtype)
        signs.pos = 0
        old = signs.install_children(model, how)
        try:
            return p16_grads(torch, model, lambda m: loss_fn(
                m, x.to(dev, dtype), dev))
        finally:
            ReluSigns.restore(old)

    try:
        lc, gc = run(card, P17_DEVICE, signs.record, torch.float32)
        lh, gh = run(cpu, "cpu", signs.replay, torch.float32)
        units, flipped = signs.units, signs.flipped
        cpu.load_state_dict(start)
        lo, go = p16_grads(torch, cpu, lambda m: loss_fn(m, x, "cpu"))
        lc64, gc64 = run(card, P17_DEVICE, signs.replay, torch.float64)
        lh64, gh64 = run(cpu, "cpu", signs.replay, torch.float64)
        zero = zero_grad_leaves(cpu)
        gaps = p17_gaps(torch, gc, gh, zero)
        gaps64 = p17_gaps(torch, gc64, gh64, zero)

        def to64(g):
            return {n: v.double() for n, v in g.items()}

        card_f64 = p17_gaps(torch, to64(gc), gh64, zero)
        cpu_f64 = p17_gaps(torch, to64(gh), gh64, zero)
        bound = {n: max(P17_GRAD_TOL, P17_NOISE_K * cpu_f64[n])
                 for n in card_f64}
        over = sorted(n for n in card_f64 if card_f64[n] > bound[n])
        winograd = p17_winograd(
            torch, lambda: run(card, P17_DEVICE, signs.replay,
                               torch.float32)[1],
            lambda g: p17_gaps(torch, to64(g), gh64, zero), over, bound,
            card_f64) if over else {}
    finally:
        restore()
    worst = sorted(gaps, key=lambda n: -gaps[n])[:6]
    unexplained = [n for n in over if n not in winograd.get("leaves", {})]
    res = {"fp32": {
        "loss_card": lc, "loss_cpu": lh,
        "loss_rel_gap": abs(lc - lh) / abs(lh),
        "grad_rel_gap_max": gaps[worst[0]], "worst_leaf": worst[0],
        "card_gap_to_float64_max": max(card_f64.values()),
        "cpu_gap_to_float64_max": max(cpu_f64.values()),
        "worst_leaves_gap_card_to_f64_cpu_to_f64": [
            (n, gaps[n], card_f64[n], cpu_f64[n]) for n in worst],
        "leaves_over_bound": over, "winograd": winograd,
        "leaves_unexplained": unexplained,
        "loss_rel_gap_own_decisions": abs(lc - lo) / abs(lo),
        "grad_rel_gap_own_decisions": max(p17_gaps(torch, gc, go,
                                                   zero).values())},
        "float64": {
            "loss_card": lc64, "loss_cpu": lh64,
            "loss_rel_gap": abs(lc64 - lh64) / abs(lh64),
            "grad_rel_gap_max": max(gaps64.values()),
            "worst_leaf": max(gaps64, key=gaps64.get)},
        "leaves": len(gaps), "zero_gradient_leaves": len(zero),
        "act_units": units, "act_units_flipped": flipped,
        "bounds": {"loss": P17_LOSS_TOL, "grad": P17_GRAD_TOL,
                   "grad_fp32_cpu_gap_times": P17_NOISE_K,
                   "grad_fp32_winograd": P17_WINOGRAD_TOL}}
    log(f"{tag} card vs cpu: {json.dumps(res)}")
    if res["fp32"]["loss_rel_gap"] > P17_LOSS_TOL or unexplained \
            or res["float64"]["loss_rel_gap"] > P17_LOSS_TOL \
            or res["float64"]["grad_rel_gap_max"] > P17_GRAD_TOL:
        raise AssertionError(f"{tag} card vs cpu: {res}")
    return res


def p17_winograd(torch, card_grads, to_f64, over, bound, card_f64) -> dict:
    """The leaves of ``over`` whose fp32 gap cuDNN's Winograd weight
    gradient explains: the card's fp32 run again under the profiler
    launched a cuDNN Winograd kernel, the same run with cuDNN off
    (PyTorch's own im2col and GEMM convolutions) brings the leaf within
    its ``bound``, and the gap with cuDNN stays within P17_WINOGRAD_TOL.
    (cuDNN 9 takes its nonfused 9x9/5x5 Winograd for the weight gradient
    of a one-channel 5x5 convolution, LeNet's first, whatever the
    deterministic and benchmark settings: ~1e-3 of the largest entry
    where the CPU and PyTorch's own convolution are within 4e-7.)"""
    if P17_DEVICE != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        card_grads()
        torch.cuda.synchronize()
    kernels = sorted({e.name.split("(")[0] for e in prof.events()
                      if "winograd" in e.name.lower()})
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        plain = to_f64(card_grads())
    finally:
        torch.backends.cudnn.enabled = was
    leaves = {n: {"gap_cudnn": card_f64[n], "gap_without_cudnn": plain[n],
                  "bound": bound[n]} for n in over
              if kernels and plain[n] <= bound[n]
              and card_f64[n] <= P17_WINOGRAD_TOL}
    return {"kernels": kernels, "leaves": leaves,
            "gap_without_cudnn_max": max(plain.values())}


def p17_split(rows) -> dict:
    """Device ms of a profiled step by kind: the convolutions (cuDNN's and
    PyTorch's own depthwise kernels), the matmuls, PyTorch's other own
    kernels (BatchNorm's composition, ReLU6, the residual adds, casts,
    the optimizer's glue) and the port's Adam kernel."""
    out = {"convolution": 0.0, "gemm": 0.0, "pytorch_elementwise": 0.0,
           "adam_kernel": 0.0, "other": 0.0}
    conv = re.compile(r"conv|cudnn|xmma|implicit|depthwise|wgrad|dgrad|"
                      r"fprop|sm90_xmma|winograd", re.I)
    for ms, _, name in rows:
        if "adam" in name.lower():
            out["adam_kernel"] += ms
        elif conv.search(name):
            out["convolution"] += ms
        elif re.search(r"gemm|cutlass|cublas", name, re.I):
            out["gemm"] += ms
        elif "at::native" in name:
            out["pytorch_elementwise"] += ms
        else:
            out["other"] += ms
    total = sum(out.values())
    out["total"] = total
    out["bn_and_elementwise_share"] = out["pytorch_elementwise"] / total \
        if total else None
    out["convolution_share"] = out["convolution"] / total if total else None
    return out


def p17_state_dtypes(torch, step) -> dict:
    """The parameters' dtypes (counted), and every master and moment of
    the optimizer state fp32 (raises otherwise)."""
    params: dict = {}
    for p in step.params.values():
        params[str(p.dtype)] = params.get(str(p.dtype), 0) + 1
    tensors = dict(step.state.get("fused", {}))
    for n, slots in step.state["slots"].items():
        tensors.update({f"{n}.{k}": t for k, t in slots.items()})
    bad = [k for k, t in tensors.items() if t.dtype != torch.float32]
    masters = sum(k.endswith("master") for k in tensors)
    if bad or not masters:
        raise AssertionError(f"optimizer state dtypes: {bad[:8]}, "
                             f"{masters} masters")
    return {"param_dtypes": params, "fp32_state_tensors": len(tensors),
            "masters": masters, "fused_state": "fused" in step.state}


def p17_profile(torch, step, batch, steps: int = 2) -> dict:
    """torch.profiler over ``steps`` replays: device ms a step, the busy
    share of the wall, the split of ``p17_split`` and the largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    x, y = (t.to(P17_DEVICE) for t in batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, labels=(y,))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_rows(prof, steps)
    device_ms = sum(r[0] for r in rows) if rows else None
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "split_ms": p17_split(rows), "launches": sum(r[1] for r in rows),
            "top_ms_launches_name": rows[:14]}


def mv2_model(torch, device: str, dtype: str = "bfloat16"):
    from paddle_tpu_torch.amp import cast_model_to_low_precision
    from paddle_tpu_torch.models import mobilenet_v2
    net = mobilenet_v2(num_classes=MV2_CLASSES, scale=1.0,
                       data_format="NHWC", device=device, seed=SEED)
    return cast_model_to_low_precision(net, dtype) \
        if dtype != "float32" else net


def mv2_fit(torch, card: str) -> tuple:
    """(a): MV2_STEPS captured steps through Model.fit, the same steps
    eager, a profiled replay, a nondeterministic replay's ms, and the
    card against the CPU."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import TrainStep
    rng = np.random.default_rng(SEED + 170)
    t0 = time.perf_counter()
    batches = [(p17_images(torch, MV2_BATCH, MV2_HW, SEED + 171 + k,
                           nhwc=True).to(torch.bfloat16),
                torch.from_numpy(rng.integers(0, MV2_CLASSES, MV2_BATCH)))
               for k in range(MV2_STEPS)]
    data_s = time.perf_counter() - t0
    restore = flag_scope({"fused_adam": True, "deterministic": True})
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = mv2_model(torch, P17_DEVICE)
        n_params = sum(p.numel() for p in net.parameters())
        before = host_copy(dict(net.named_buffers()))
        model = Model(net, loss=rn_loss, optimizer=Adam(MV2_LR))
        rec = hapi_recorder(torch)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(batches, epochs=1, callbacks=[rec], verbose=0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(v) for v in rec.losses]
        step = model._train_step
        captures, capture_ms = step.captures, step.capture_ms
        ms = [rec.events[k - 1].elapsed_time(rec.events[k])
              for k in range(1, len(rec.events))] if rec.events else []
        step_ms = float(np.median(ms[1:])) if len(ms) > 1 else None
        after = host_copy(dict(net.named_buffers()))
        unmoved = [n for n in after if torch.equal(after[n], before[n])]
        lowp = p17_state_dtypes(torch, step)
        busy = p17_profile(torch, step, batches[0]) \
            if P17_DEVICE == "cuda" else None
        del model, step, net
        torch.cuda.empty_cache()
        eager = TrainStep(mv2_model(torch, P17_DEVICE), Adam(MV2_LR),
                          rn_loss, compiled=False)
        eager_losses = [float(eager(x.to(P17_DEVICE),
                                    labels=(y.to(P17_DEVICE),))["loss"])
                        for x, y in batches]
        del eager
    finally:
        restore()
    torch.cuda.empty_cache()
    # the default (nondeterministic) convolutions' replay ms
    replay_ms = None
    if P17_DEVICE == "cuda":
        restore = flag_scope({"fused_adam": True})
        try:
            nd = TrainStep(mv2_model(torch, P17_DEVICE), Adam(MV2_LR),
                           rn_loss)
            xb = [(x.to(P17_DEVICE), y.to(P17_DEVICE))
                  for x, y in batches[:4]]
            _, nd_ms = rn_timed_steps(torch, nd, xb)
            replay_ms = float(np.median(nd_ms[1:]))
            del nd, xb
        finally:
            restore()
        torch.cuda.empty_cache()

    log(f"mobilenet_v2 fit steps [{card}]: losses {losses}, eager "
        f"{eager_losses}, captures {captures}, step ms {step_ms}, "
        f"replay ms (nondeterministic) {replay_ms}, peak GB {peak}, "
        f"launches {nonzero(counts)}, profile {json.dumps(busy)}")

    res = {"model": "mobilenet_v2(scale=1.0)", "parameters": n_params,
           "dtype": "bfloat16, fp32 masters", "layout": "NHWC",
           "image": MV2_HW, "batch": MV2_BATCH, "steps": MV2_STEPS,
           "optimizer": f"Adam({MV2_LR}) under fused_adam",
           "deterministic": True, "losses": losses,
           "eager_losses": eager_losses,
           "captured_equals_eager": losses == eager_losses,
           "captures": captures, "capture_ms": capture_ms,
           "step_stream_ms": ms, "step_ms_median_2_to_8": step_ms,
           "images_per_s": MV2_BATCH / step_ms * 1e3 if step_ms else None,
           "replay_ms_nondeterministic": replay_ms,
           "images_per_s_nondeterministic": MV2_BATCH / replay_ms * 1e3
           if replay_ms else None,
           "peak_allocated_gb": peak, "fit_s": fit_s, "data_s": data_s,
           "bn_buffers_unmoved": unmoved, "low_precision_state": lowp,
           "launches": nonzero(counts), "profiled_replays": busy,
           "card": card}
    log(f"mobilenet_v2 fit [{card}]: {json.dumps(res)}")
    if len(losses) != MV2_STEPS or not all(np.isfinite(losses)) \
            or losses != eager_losses or unmoved \
            or (P17_DEVICE == "cuda" and captures != 1):
        raise AssertionError(f"mobilenet_v2 fit: {res}")
    path_launches("mv2_fit", counts, {k: int(k == "adam_leaf")
                                      for k in counts}
                  if P17_DEVICE == "cuda" else {k: 0 for k in counts},
                  MV2_STEPS)
    return res, counts


def mv2_card_against_cpu(torch, card: str) -> dict:
    """(a)'s card against CPU: MobileNetV2 1.0 in fp32 at MV2_CPU_BATCH
    images of 224 (``p17_card_against_cpu``)."""

    def loss_fn(m, x, dev):
        return rn_loss(m(x), torch.arange(MV2_CPU_BATCH, device=dev))

    res = p17_card_against_cpu(
        torch, "mobilenet_v2", lambda d: mv2_model(torch, d, "float32"),
        p17_images(torch, MV2_CPU_BATCH, MV2_HW, SEED, nhwc=True), loss_fn)
    res["card"] = card
    return res


def ssd_batch(torch, seed: int) -> tuple:
    """SSD_BATCH images and up to SSD_GT ground-truth boxes each
    (normalised corners, labels 1..classes, -1 padded)."""
    rng = np.random.default_rng(seed)
    hw = SSD_CFG["image_size"]
    x = rng.standard_normal((SSD_BATCH, 3, hw, hw), dtype=np.float32)
    n = rng.integers(1, SSD_GT + 1, SSD_BATCH)
    xy = rng.uniform(0.0, 0.6, (SSD_BATCH, SSD_GT, 2))
    wh = rng.uniform(0.1, 0.4, (SSD_BATCH, SSD_GT, 2))
    box = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    lab = rng.integers(1, SSD_CFG["num_classes"] + 1, (SSD_BATCH, SSD_GT))
    pad = np.arange(SSD_GT)[None, :] >= n[:, None]
    box[pad] = 0.0
    lab[pad] = -1
    return tuple(torch.from_numpy(a) for a in (x, box, lab))


class NmsChoices:
    """The NMS decisions of one ``detection_output``, shared with another
    run, as ``BeamChoices`` shares beam decisions. Recording (the card),
    the port's ``ops.detection._nms_loop`` runs as it is and its
    selections are kept. Replaying (the CPU), the port's loop runs on the
    CPU's scores, then again in float64 with each recorded selection
    raised to the largest CPU score among it and the later selections
    (their order, reversed by rounding at a tie: at most SSD_TIE / 2) plus
    SSD_TIE / 2. That run must give the recorded selections back exactly:
    each was then within SSD_TIE of the largest live CPU score after the
    ones before it, and together they are an NMS sequence under the CPU's
    overlaps. The recorded selections take the CPU's place; the slots
    whose index differs from the CPU's own are counted."""

    def __init__(self, torch) -> None:
        from paddle_tpu_torch.ops import detection
        self.torch, self.det = torch, detection
        self.orig = detection._nms_loop
        self.choices: list = []
        self.pos = 0
        self.replaying = False
        self.ties = 0
        self.gap = 0.0

    def loop(self, iou, scores, iou_threshold, score_threshold, max_out):
        torch = self.torch
        idx, valid = self.orig(iou, scores, iou_threshold, score_threshold,
                               max_out)
        if not self.replaying:
            self.choices.append((idx.cpu(), valid.cpu()))
            return idx, valid
        want, want_valid = (t.to(scores.device)
                            for t in self.choices[self.pos])
        self.pos += 1
        s64 = scores.double()
        neg = torch.full(want.shape, -np.inf, dtype=s64.dtype,
                         device=s64.device)
        taken = torch.where(want_valid, s64.gather(-1, want.clamp(min=0)),
                            neg)
        # the largest score among each selection and the later ones
        later = taken.flip(-1).cummax(-1).values.flip(-1)
        gaps = (later - taken)[want_valid]
        if gaps.numel():
            self.gap = max(self.gap, float(gaps.max()))
        if self.gap > SSD_TIE / 2:
            raise AssertionError(f"nms replay: the card's selections are "
                                 f"out of order by {self.gap} on the CPU")
        order = torch.arange(max_out, 0, -1, dtype=s64.dtype,
                             device=s64.device)
        n = scores.shape[-1]
        # an empty slot writes to a spare column
        raised = torch.cat([s64, s64[..., :1]], -1).scatter(
            -1, torch.where(want_valid, want, torch.full_like(want, n)),
            torch.where(want_valid, later + SSD_TIE / 2 + order * 1e-12,
                        neg))[..., :n]
        forced, forced_valid = self.orig(iou, raised, iou_threshold,
                                         score_threshold, max_out)
        if not (torch.equal(forced, want)
                and torch.equal(forced_valid, want_valid)):
            raise AssertionError("nms replay: the card's selections are not "
                                 "the CPU's to within SSD_TIE")
        self.ties += int((want != idx).sum())
        return want, want_valid

    def __enter__(self):
        self.det._nms_loop = self.loop
        return self

    def __exit__(self, *exc):
        self.det._nms_loop = self.orig


def ssd_predict_gap(torch, card_out, cpu_out) -> dict:
    """Each image's valid rows: the same count and labels, scores and
    boxes within SSD_TIE / 1e-5; a row whose place differs only by a
    score within SSD_TIE of its neighbour's is an order tie (counted)."""
    worst, order_ties, rows = 0.0, 0, 0
    for (co, cv), (ho, hv) in zip(card_out, cpu_out):
        co, cv = co.cpu(), cv.cpu()
        if not torch.equal(cv, hv):
            raise AssertionError(f"ssd predict: valid {cv} != {hv}")
        co, ho = co[cv], ho[hv]
        rows += len(co)
        for i in range(len(co)):
            if torch.equal(co[i, 0], ho[i, 0]) and float(
                    (co[i, 1:] - ho[i, 1:]).abs().max()) <= 1e-5:
                worst = max(worst, float((co[i, 1:] - ho[i, 1:]).abs().max()))
                continue
            # a swap with a row of the same score to rounding
            match = [j for j in range(len(ho))
                     if torch.equal(co[i, 0], ho[j, 0])
                     and float((co[i, 1:] - ho[j, 1:]).abs().max()) <= 1e-5
                     and abs(float(ho[j, 1] - ho[i, 1])) <= SSD_TIE]
            if not match:
                raise AssertionError(f"ssd predict: row {i} {co[i]} has no "
                                     f"match on the CPU")
            order_ties += 1
    return {"rows": rows, "max_abs_gap": worst, "order_ties": order_ties}


def ssd_check(torch, card: str) -> dict:
    """(b): the loss card against CPU, SSD_STEPS captured steps, predict
    card against CPU."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import SSDLite
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import TrainStep
    x, box, lab = ssd_batch(torch, SEED + 175)

    def make(dev):
        return SSDLite(**SSD_CFG, device=dev, seed=SEED)

    def loss_fn(m, xx, dev):
        return m.loss(xx, box.to(dev), lab.to(dev))

    against = p17_card_against_cpu(torch, "ssdlite", make, x, loss_fn)
    net = make(P17_DEVICE)
    priors_equal = bool(torch.equal(net.priors.cpu(), make("cpu").priors))

    def step_loss(out, gt, gl):
        from paddle_tpu_torch.ops.detection import ssd_loss
        return ssd_loss(out[0], out[1], gt, gl, net.priors).mean()

    step = TrainStep(net, Momentum(0.01, 0.9), step_loss, seed=SEED)
    kernels.reset_launch_counts()
    losses, ms = [], []
    for k in range(SSD_STEPS):
        xb, bb, lb = ssd_batch(torch, SEED + 176 + k)
        t0 = time.perf_counter()
        losses.append(float(step(xb.to(P17_DEVICE), labels=(
            bb.to(P17_DEVICE), lb.to(P17_DEVICE)))["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    captures = step.captures
    del step
    # predict on the trained weights, card and CPU
    net.eval()
    cpu = cpu_twin(torch, net, make).eval()
    with torch.no_grad():
        t0 = time.perf_counter()
        with NmsChoices(torch) as rec:
            card_out = net.predict(x.to(P17_DEVICE), keep_top_k=SSD_TOP_K,
                                   score_threshold=SSD_SCORE)
        if P17_DEVICE == "cuda":
            torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        rec.replaying = True
        with rec:
            cpu_out = cpu.predict(x, keep_top_k=SSD_TOP_K,
                                  score_threshold=SSD_SCORE)
    gap = ssd_predict_gap(torch, card_out, cpu_out)
    res = {"config": SSD_CFG, "batch": SSD_BATCH, "priors":
           int(net.priors.shape[0]), "priors_equal_cpu": priors_equal,
           "loss_card_against_cpu": against, "losses": losses,
           "step_wall_ms": ms, "captures": captures,
           "launches": nonzero(counts), "predict_s": predict_s,
           "predict": dict(gap, nms_ties=rec.ties, nms_order_gap=rec.gap,
                           valid_rows_card=[int(v.sum())
                                            for _, v in card_out]),
           "card": card}
    log(f"ssdlite [{card}]: {json.dumps(res)}")
    if not all(np.isfinite(losses)) or not priors_equal \
            or (P17_DEVICE == "cuda" and captures != 1) or nonzero(counts):
        raise AssertionError(f"ssdlite: {res}")
    return res


def gan_check(torch, card: str) -> dict:
    """(c): GAN_STEPS GANTrainStep calls on the card (SGD on both sides);
    the first against the same step on the CPU fed the card's z: both
    losses within P17_LOSS_TOL relative, every parameter and statistic
    within P17_GRAD_TOL of its model's largest update / entry."""
    from paddle_tpu_torch.models import Discriminator, GANTrainStep, Generator
    from paddle_tpu_torch.optimizer import SGD

    def make(dev):
        g = Generator(**GAN_CFG, device=dev, seed=SEED)
        d = Discriminator(base=GAN_CFG["base"], device=dev, seed=SEED + 1)
        return g, d, GANTrainStep(g, d, SGD(GAN_LR), SGD(GAN_LR), seed=SEED)

    rng = np.random.default_rng(SEED + 180)
    reals = [torch.from_numpy(np.tanh(rng.standard_normal(
        (GAN_BATCH, 1, 28, 28))).astype(np.float32))
        for _ in range(GAN_STEPS)]
    g, d, step = make(P17_DEVICE)
    cg, cd, cstep = make("cpu")
    cg.load_state_dict({k: v.cpu() for k, v in g.state_dict().items()})
    cd.load_state_dict({k: v.cpu() for k, v in d.state_dict().items()})
    before = {**{"g." + k: v.detach().cpu().clone()
                 for k, v in g.state_dict().items()},
              **{"d." + k: v.detach().cpu().clone()
                 for k, v in d.state_dict().items()}}
    z = step._z(GAN_BATCH, torch.Generator(
        device=P17_DEVICE).manual_seed(SEED))
    cstep._z = lambda n, gen: z.cpu()
    out = [step(reals[0].to(P17_DEVICE))]
    after = {**{"g." + k: v.detach().cpu().clone()
                for k, v in g.state_dict().items()},
             **{"d." + k: v.detach().cpu().clone()
                for k, v in d.state_dict().items()}}
    cout = cstep(reals[0])
    cafter = {**{"g." + k: v.detach().clone()
                 for k, v in cg.state_dict().items()},
              **{"d." + k: v.detach().clone()
                 for k, v in cd.state_dict().items()}}
    gaps = {}
    for side in ("g.", "d."):
        keys = [k for k in after if k.startswith(side)]
        top = max(float((cafter[k] - before[k]).abs().max()) for k in keys
                  if cafter[k].is_floating_point())
        for k in keys:
            if after[k].is_floating_point():
                gaps[k] = float((after[k] - cafter[k]).abs().max()) / top
    t0 = time.perf_counter()
    for r in reals[1:]:
        out.append(step(r.to(P17_DEVICE)))
    losses = [{k: float(v) for k, v in o.items()} for o in out]
    steps_s = time.perf_counter() - t0
    res = {"config": GAN_CFG, "batch": GAN_BATCH, "steps": GAN_STEPS,
           "optimizer": f"SGD({GAN_LR}) both", "losses": losses,
           "first_step_cpu": {k: float(v) for k, v in cout.items()},
           "d_loss_rel_gap": abs(losses[0]["d_loss"] - float(cout["d_loss"]))
           / abs(float(cout["d_loss"])),
           "g_loss_rel_gap": abs(losses[0]["g_loss"] - float(cout["g_loss"]))
           / abs(float(cout["g_loss"])),
           "state_rel_gap_max": max(gaps.values()),
           "state_rel_gap_worst": max(gaps, key=gaps.get),
           "later_steps_s": steps_s, "card": card}
    log(f"dcgan [{card}]: {json.dumps(res)}")
    if not all(np.isfinite(v) for o in losses for v in o.values()) \
            or res["d_loss_rel_gap"] > P17_LOSS_TOL \
            or res["g_loss_rel_gap"] > P17_LOSS_TOL \
            or res["state_rel_gap_max"] > P17_GRAD_TOL:
        raise AssertionError(f"dcgan: {res}")
    return res


def small_models_check(torch, card: str) -> dict:
    """(d): VGG-16-BN (dropout 0) at 224, MobileNetV1 1.0 at 224 and
    LeNet at 28, each one forward and backward card against CPU."""
    from paddle_tpu_torch.models import LeNet, mobilenet_v1
    from paddle_tpu_torch.models.vgg import VGG, _CFGS, _make_layers

    def vgg16_bn(dev):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return VGG(_make_layers(_CFGS["D"], True, "NCHW", dev, gen),
                   num_classes=1000, dropout=0.0, device=dev, generator=gen)

    def loss_fn(n):
        def fn(m, x, dev):
            return rn_loss(m(x), torch.arange(n, device=dev) % 10)
        return fn

    res = {}
    for tag, make, x in (
            ("vgg16_bn", vgg16_bn, p17_images(torch, VGG_BATCH, 224,
                                              SEED + 185)),
            ("mobilenet_v1", lambda d: mobilenet_v1(device=d, seed=SEED),
             p17_images(torch, MV1_BATCH, 224, SEED + 186)),
            ("lenet", lambda d: LeNet(device=d, seed=SEED),
             p17_images(torch, LENET_BATCH, 28, SEED + 187, c=1))):
        res[tag] = p17_card_against_cpu(torch, tag, make, x,
                                        loss_fn(x.shape[0]))
        torch.cuda.empty_cache()
    res["card"] = card
    return res


def ops_sweep_vision(torch, card: str) -> dict:
    """(e): every VISION_CASES and DET_CASES call on the card against the
    CPU; the sampled ops by shape, device and the same draw again."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.testing import op_cases as C
    mods = {m: getattr(ops, m) for m in C.VISION_MODULES + ("detection",)}
    t0 = time.perf_counter()
    worst, done = 0.0, set()
    for mod, name, args, kw in C.VISION_CASES + C.DET_CASES:
        fn = getattr(mods[mod], name)

        def call(dev):
            return fn(*_sweep_args(torch, args, dev),
                      **_sweep_arg(torch, kw, dev))

        got, want = call(P17_DEVICE), call("cpu")
        try:
            worst = max(worst, _sweep_compare(torch, got, want,
                                              f"{mod}.{name}", P17_DEVICE))
        except AssertionError:
            bad = [(tuple(g.shape), float((g.cpu().double()
                                           - w.double()).abs().max()),
                    torch.nonzero((g.cpu() != w)).tolist()[:6])
                   for g, w in zip(_sweep_flat(got), _sweep_flat(want))
                   if isinstance(w, torch.Tensor)]
            raise AssertionError(f"{mod}.{name}: card against CPU: {bad}")
        done.add(name)
    for mod, name, args, kw in C.DET_CREATION:
        worst = max(worst, _sweep_compare(
            torch, getattr(mods[mod], name)(*args, **kw, device=P17_DEVICE),
            getattr(mods[mod], name)(*args, **kw, device="cpu"),
            name, P17_DEVICE))
        done.add(name)
    nnf = mods["nn_functional"]
    x = torch.arange(2 * 3 * 6 * 7, dtype=torch.float32,
                     device=P17_DEVICE).reshape(2, 3, 6, 7)
    crops = [nnf.random_crop(x, (4, 5), key=torch.Generator(
        device=P17_DEVICE).manual_seed(s)) for s in (3, 3, 4)]
    masks = [nnf.dropout_keep_mask(torch.Generator(
        device=P17_DEVICE).manual_seed(s), 0.7, (256, 256))
        for s in (5, 5, 6)]
    # an int seed and no key draw on the card unless the CPU is asked for
    by_seed = [nnf.dropout_keep_mask(s, 0.7, (256, 256), device=P17_DEVICE
                                     if P17_DEVICE == "cpu" else None)
               for s in (5, 5, None)]
    if not (crops[0].shape == (2, 3, 4, 5)
            and crops[0].device.type == P17_DEVICE
            and torch.equal(crops[0], crops[1])
            and all(m.device.type == P17_DEVICE for m in masks + by_seed)
            and torch.equal(masks[0], masks[1])
            and not torch.equal(masks[0], masks[2])
            and torch.equal(by_seed[0], by_seed[1])
            and all(abs(float(m.float().mean()) - 0.7) < 0.01
                    for m in (masks[0], by_seed[0], by_seed[2]))):
        raise AssertionError("vision sampled ops on the card")
    done |= C.VISION_RANDOM
    res = {"cases": len(C.VISION_CASES) + len(C.DET_CASES)
           + len(C.DET_CREATION), "functions": len(done),
           "max_rel_err_card_vs_cpu": worst, "bound": [OPS_RTOL, OPS_ATOL],
           "sweep_s": time.perf_counter() - t0, "card": card}
    log(f"vision ops sweep [{card}]: {json.dumps(res)}")
    return res


def run_phase17(torch) -> tuple:
    """Phase 17. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts, failed = {}, {}, []
    report["mv2_fit"], counts["mv2_fit"] = mv2_fit(torch, card)
    # each later check runs whatever an earlier one found; the phase
    # raises at its end, naming every check that failed
    for name, check in (("mv2_card_against_cpu", mv2_card_against_cpu),
                        ("ssdlite", ssd_check), ("dcgan", gan_check),
                        ("vision_models", small_models_check),
                        ("ops_sweep_vision", ops_sweep_vision)):
        torch.cuda.empty_cache()
        try:
            report[name] = check(torch, card)
        except AssertionError as e:
            log(f"phase 17 {name} FAILED: {e}")
            failed.append(name)
    report["phase17_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {report['phase17_s']:.1f} s [{card}]")
    if failed:
        raise AssertionError(f"phase 17: {failed} failed (see the log)")
    return report, counts


# ---------------------------------------------------------------------------
# Phase 18: the slice of MoE, Transformer-XL, the recommenders and the data
# modules (fp32, TF32 off). (a) Transformer-XL at enwik8 "base" width
# through its captured segment-recurrent step with Adam under fused_adam
# (rows 1 and 11), bit for bit with the same steps eager, then card
# against CPU at 2 layers; (b) MoE at Switch-Base's expert width with
# expert parallelism (four Gloo ranks sharing the card; under NCCL on four
# cards) against one card's TrainStep; (c) RecommenderSystem through
# Model.fit and DeepFM at Criteo's 26 fields, card against CPU; (d) the
# Tokenizer, Imikolov, the reader and the distributions.
# `python3 chip_smoke.py --zoo` runs this phase alone.
# ---------------------------------------------------------------------------

# where phase 18 runs (a CPU rehearsal sets "cpu")
P18_DEVICE = "cuda"
# enwik8 "base" of Dai et al. 2019 as the authors'
# pytorch/run_enwik8_base.sh sets it (n_layer 12, d_model 512, n_head 8,
# d_head 64, d_inner 2048, tgt_len 512, mem_len 512, batch_size 22,
# dropout 0.1; enwik8's 204 byte values); lr its 0.00025
TXL_CFG = dict(vocab_size=204, d_model=512, n_heads=8, d_ff=2048,
               n_layers=12, mem_len=512, dropout=0.1)
TXL_TGT_LEN, TXL_BATCH, TXL_SEGMENTS, TXL_LR = 512, 22, 6, 2.5e-4
# card against CPU: 2 layers, batch 2, the full widths, dropout 0, two
# segments (the second reading the first's memory): the loss's relative
# gap and each leaf's largest gradient gap over its largest entry
TXL_CPU_LAYERS, TXL_CPU_BATCH = 2, 2
P18_LOSS_TOL, P18_GRAD_TOL = 1e-5, 1e-4
# (b): 3 Adam steps at each mesh against one card's TrainStep on the
# global batch: the loss and aux_loss within P18_MOE_LOSS_TOL relative,
# every whole parameter within P18_MOE_PARAM_TOL of its largest entry or
# P18_MOE_ATOL absolute (a fiftieth of one Adam step: a near-zero
# gradient entry's fp32 noise, summed over dp in another order, moves
# Adam's update by a few thousandths of a step, 0.42% seen at dp 2 x
# ep 2), the dropped choices equal
# the MoE net of tests/test_moe.py at Switch-Base's expert width (Fedus et
# al. 2021: d_model 768, d_ff 3072; 8 experts, top-2, capacity factor
# 1.25), four residual MoE blocks, 16 classes
MOE_SWITCH = dict(d=768, h=3072, e=8, classes=16, cf=1.25, blocks=4,
                  in_dim=768, seed=SEED + 184)
MOE_CHIP_BATCH, MOE_CHIP_T, MOE_CHIP_STEPS, MOE_CHIP_LR = 32, 128, 3, 1e-4
P18_MOE_LOSS_TOL, P18_MOE_PARAM_TOL = 1e-5, 5e-5
P18_MOE_ATOL = MOE_CHIP_LR / 50
P18_DIR = "chip_smoke_zoo"  # the ranks' and the data files (removed)
# (c): MovieLens-1M's widths (the model's defaults) fed by the synthetic
# Movielens through fit, 4 captured steps; DeepFM on 26 fields as
# Criteo's categorical features, 100,000 ids each
REC_BATCH, REC_LR = 64, 1e-3
DEEPFM_FIELDS, DEEPFM_IDS, DEEPFM_EMBED = 26, 100_000, 16
DEEPFM_HIDDEN, DEEPFM_BATCH = (400, 400, 400), 2048
# (d): distributions card against CPU
DIST_TOL = 1e-5
PATH_KERNELS.update({"txl": ("layer_norm", "adam_leaf"),
                     "moe_ep": ("adam_leaf",), "rec_fit": ("adam_leaf",)})


def txl_model(torch, device: str, layers: int, dropout: float):
    from paddle_tpu_torch.models import TransformerXL, TransformerXLConfig
    cfg = TransformerXLConfig(**dict(TXL_CFG, n_layers=layers,
                                     dropout=dropout))
    return TransformerXL(cfg, device=device, seed=SEED + 180)


def txl_stream(torch, batch: int, tokens: int, seed: int):
    """Seeded bytes (enwik8's 204 values): one stream a row."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, TXL_CFG["vocab_size"],
                                         (batch, tokens)))


def txl_segments(torch, stream, n: int, t: int, device: str) -> list:
    return [(stream[:, s * t:(s + 1) * t].to(device),
             stream[:, s * t + 1:(s + 1) * t + 1].to(device))
            for s in range(n)]


def txl_card_against_cpu(torch) -> dict:
    """2 layers at the full widths, dropout 0, one forward and backward
    over two segments (the second reading the first's memory), on the
    card and on the CPU from the same weights."""
    cpu = txl_model(torch, "cpu", TXL_CPU_LAYERS, 0.0)
    card = txl_model(torch, P18_DEVICE, TXL_CPU_LAYERS, 0.0)
    card.load_state_dict(cpu.state_dict())
    t = TXL_TGT_LEN
    stream = txl_stream(torch, TXL_CPU_BATCH, 2 * t + 1, SEED + 181)

    def loss(m, dev):
        x = stream.to(dev)
        l1, mems = m.loss(x[:, :t], x[:, 1:t + 1])
        l2, _ = m.loss(x[:, t:2 * t], x[:, t + 1:2 * t + 1], mems)
        return l1 + l2

    t0 = time.perf_counter()
    lc, gc = p16_grads(torch, card, lambda m: loss(m, P18_DEVICE))
    lh, gh = p16_grads(torch, cpu, lambda m: loss(m, "cpu"))
    gaps = grad_gaps(torch, gc, gh)
    return {"loss_card": lc, "loss_cpu": lh,
            "loss_rel_gap": abs(lc - lh) / abs(lh),
            "grad_rel_gap_max": max(gaps.values()),
            "grad_rel_gap_worst_leaf": max(gaps, key=gaps.get),
            "bounds": {"loss": P18_LOSS_TOL, "grad": P18_GRAD_TOL},
            "layers": TXL_CPU_LAYERS, "batch": TXL_CPU_BATCH,
            "both_s": time.perf_counter() - t0}


def txl_fit(torch, card: str) -> tuple:
    """(a): TXL_SEGMENTS consecutive segments of one stream through the
    captured TransformerXLTrainStep (the counts read around them), the
    same segments eager from the same weights and seed (losses, memories
    and valid bit for bit), reset_mems on both and one more step (equal,
    and equal to a fresh step's first on the same weights), then the card
    against the CPU. Returns (report, counts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import TransformerXLTrainStep
    from paddle_tpu_torch.optimizer import Adam
    t, b, n = TXL_TGT_LEN, TXL_BATCH, TXL_SEGMENTS
    stream = txl_stream(torch, b, n * t + 1, SEED + 182)
    segs = txl_segments(torch, stream, n, t, P18_DEVICE)
    restore = flag_scope({"fused_adam": True})
    try:
        torch.cuda.empty_cache()
        model = txl_model(torch, P18_DEVICE, TXL_CFG["n_layers"],
                          TXL_CFG["dropout"])
        n_params = sum(p.numel() for p in model.parameters())
        step = TransformerXLTrainStep(model, Adam(TXL_LR), batch_size=b)
        losses, valid, snaps, ms, peaks = [], [], [], [], []
        snap_bytes = 0
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for ids, tgt in segs:
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss = step(ids, tgt)["loss"]
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            peaks.append((torch.cuda.max_memory_allocated() - snap_bytes)
                         / 2 ** 30)
            losses.append(float(loss))
            valid.append(int(step.mems["valid"]))
            snaps.append([m.clone() for m in step.mems["layers"]])
            snap_bytes += sum(m.numel() * 4 for m in snaps[-1])
        counts = kernels.launch_counts()
        captures, capture_ms = step.captures, step.capture_ms
        # the same segments eager, from the same weights and seed
        twin = txl_model(torch, P18_DEVICE, TXL_CFG["n_layers"],
                         TXL_CFG["dropout"])
        eager = TransformerXLTrainStep(twin, Adam(TXL_LR), batch_size=b,
                                       compiled=False)
        eager_losses, mems_equal, eager_valid = [], [], []
        for (ids, tgt), snap in zip(segs, snaps):
            eager_losses.append(float(eager(ids, tgt)["loss"]))
            eager_valid.append(int(eager.mems["valid"]))
            mems_equal.append(all(bool(torch.equal(a, c)) for a, c in zip(
                eager.mems["layers"], snap)))
        del snaps
        params_equal = all(bool(torch.equal(p, q)) for p, q in zip(
            model.parameters(), twin.parameters()))
        # reset_mems: in place, no new capture; the next step equals the
        # eager twin's after its own reset, and a fresh step's first on
        # the same weights and generator state
        ptrs = [m.data_ptr() for m in step.mems["layers"]]
        step.reset_mems(b)
        eager.reset_mems(b)
        fresh_model = txl_model(torch, P18_DEVICE, TXL_CFG["n_layers"],
                                TXL_CFG["dropout"])
        fresh_model.load_state_dict(twin.state_dict())
        fresh = TransformerXLTrainStep(fresh_model, Adam(TXL_LR),
                                       batch_size=b, compiled=False)
        fresh.generator.set_state(eager.generator.get_state())
        reset = {"captured": float(step(*segs[0])["loss"]),
                 "eager": float(eager(*segs[0])["loss"]),
                 "fresh": float(fresh(*segs[0])["loss"]),
                 "in_place": [m.data_ptr() for m in step.mems["layers"]]
                 == ptrs, "captures_after": step.captures}
        del model, twin, step, eager, fresh, fresh_model
    finally:
        restore()
    torch.cuda.empty_cache()
    against_cpu = txl_card_against_cpu(torch)
    step_ms = float(np.median(ms[2:]))
    res = {"config": dict(TXL_CFG, tgt_len=t, batch=b),
           "source": "Dai et al. 2019, pytorch/run_enwik8_base.sh",
           "parameters": n_params, "segments": n,
           "optimizer": f"Adam({TXL_LR}) under fused_adam",
           "losses": losses, "eager_losses": eager_losses,
           "captured_equals_eager": losses == eager_losses,
           "memories_equal": mems_equal, "valid": valid,
           "eager_valid": eager_valid, "params_equal": params_equal,
           "captures": captures, "capture_ms": capture_ms,
           "step_ms": ms, "step_ms_median_3_to_6": step_ms,
           "tokens_per_s": b * t / step_ms * 1e3,
           "peak_allocated_gb": max(peaks), "reset_mems": reset,
           "launches": nonzero(counts), "card_against_cpu": against_cpu,
           "card": card}
    log(f"txl fit [{card}]: {json.dumps(res)}")
    want_valid = [min(TXL_CFG["mem_len"], t * (s + 1)) for s in range(n)]
    ln = counts.get("layer_norm", 0)
    if not all(np.isfinite(losses)) or losses != eager_losses \
            or not all(mems_equal) or not params_equal \
            or valid != want_valid or eager_valid != want_valid \
            or captures != 1 or ln != 2 * TXL_CFG["n_layers"] * n \
            or counts.get("adam_leaf", 0) != n \
            or not (reset["captured"] == reset["eager"] == reset["fresh"])\
            or not reset["in_place"] or reset["captures_after"] != 1:
        raise AssertionError(f"txl fit: {res}")
    if against_cpu["loss_rel_gap"] > P18_LOSS_TOL \
            or against_cpu["grad_rel_gap_max"] > P18_GRAD_TOL:
        raise AssertionError(f"txl card against cpu: {against_cpu}")
    return res, counts


def moe_inputs(torch) -> dict:
    rng = np.random.default_rng(SEED + 183)
    x = rng.standard_normal((MOE_CHIP_BATCH, MOE_CHIP_T,
                             MOE_SWITCH["in_dim"])).astype(np.float32)
    y = rng.integers(0, MOE_SWITCH["classes"], MOE_CHIP_BATCH)
    return dict({"moe_x": x, "moe_y": y, "steps": MOE_CHIP_STEPS,
                 "lr": MOE_CHIP_LR},
                **{f"net/{k}": v for k, v in MOE_SWITCH.items()})


def moe_reference(torch, inputs, cf: float) -> tuple:
    """One card's captured TrainStep of the same model at capacity factor
    ``cf`` on the global batch: (report, {name: whole parameter as
    numpy})."""
    from paddle_tpu_torch.ops.loss import cross_entropy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import TrainStep
    from paddle_tpu_torch.testing import dist_worker as W
    restore = flag_scope({"fused_adam": True})
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = W.moe_net(torch.device(P18_DEVICE),
                        **dict(MOE_SWITCH, cf=cf))
        step = TrainStep(net, Adam(MOE_CHIP_LR), cross_entropy)
        x = torch.from_numpy(inputs["moe_x"]).to(P18_DEVICE)
        y = torch.from_numpy(inputs["moe_y"]).to(P18_DEVICE)
        losses, aux, dropped, ms = [], [], [], []
        for _ in range(MOE_CHIP_STEPS):
            dropped.append(W.moe_dropped(net, x))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss = step(x, labels=(y,))["loss"]
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
            aux.append([float(m.aux_loss) for m in net.layers()])
        params = {n: p.detach().cpu().numpy()
                  for n, p in net.named_parameters()}
        res = {"losses": losses, "aux": aux, "dropped": dropped,
               "step_ms": ms, "captures": step.captures,
               "peak_allocated_gb": torch.cuda.max_memory_allocated()
               / 2 ** 30, "parameters": sum(v.size
                                            for v in params.values()),
               "bytes": sum(v.nbytes for v in params.values())}
        del net, step
    finally:
        restore()
    torch.cuda.empty_cache()
    return res, params


def check_moe_ranks(torch, outs, refs: dict, backend: str) -> tuple:
    """The ranks' cases against the reference at each one's capacity
    factor (``refs``: cf -> report): (report with ``bad``, the ranks'
    launch counts summed)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.testing import dist_worker as W
    e = MOE_SWITCH["e"]
    res, bad = {"backend": backend}, []
    counts = {k: 0 for k in kernels.launch_counts()}
    for case, spec in W.CHIP_MOE_CASES.items():
        ep = spec["axes"]["ep"]
        ref = refs[spec.get("cf", MOE_SWITCH["cf"])]
        r = {"mesh": spec["axes"], "cf": spec.get("cf", MOE_SWITCH["cf"])}
        losses = [o[f"{case}/loss"].tolist() for o in outs]
        r["loss_rel_gap"] = max(abs(a - b) / abs(b) for ls in losses
                                for a, b in zip(ls, ref["losses"]))
        r["aux_rel_gap"] = max(float(np.max(np.abs(
            o[f"{case}/aux"] - np.asarray(ref["aux"]))
            / np.abs(np.asarray(ref["aux"])))) for o in outs)
        # each rank counts its rows' dropped choices: summed over the
        # ranks of one expert index, the global batch's
        first = [o for o in outs if int(o[f"{case}/ep_index"]) == 0]
        r["dropped"] = sum(o[f"{case}/dropped"] for o in first).tolist()
        r["dropped_equal"] = r["dropped"] == ref["dropped"]
        worst, worst_abs, over = 0.0, 0.0, []
        for o in outs:
            for k, v in o.items():
                if k.startswith(f"{case}/param_gap/"):
                    name = k.split("/param_gap/")[1]
                    worst, worst_abs = max(worst, float(v[0])), \
                        max(worst_abs, float(v[1]))
                    if v[0] > P18_MOE_PARAM_TOL and v[1] > P18_MOE_ATOL:
                        over.append(name)
        r.update(param_rel_gap_max=worst, param_abs_gap_max=worst_abs,
                 params_over_bound=sorted(set(over)))
        held = {k.split("/held_shape/")[1]: [int(d) for d in v]
                for k, v in outs[0].items()
                if k.startswith(f"{case}/held_shape/")}
        r["experts_held"] = held["moes.0.w_in"][0]
        r["held_bytes_per_rank"] = [int(o[f"{case}/held_bytes"])
                                    for o in outs]
        r["backend_calls_per_step"] = [o[f"{case}/backend_calls"].tolist()
                                       for o in outs]
        r["step_ms_per_rank"] = [o[f"{case}/step_ms"].tolist()
                                 for o in outs]
        if f"{case}/peak_gb" in outs[0]:
            r["peak_gb_per_rank"] = [float(o[f"{case}/peak_gb"])
                                     for o in outs]
        r["captures"] = [int(o[f"{case}/captures"]) for o in outs]
        for o in outs:
            for k, c in zip(o[f"{case}/launch_names"],
                            o[f"{case}/launches"]):
                counts[str(k)] = counts.get(str(k), 0) + int(c)
        r["dropped_total"] = int(np.sum(r["dropped"]))
        if r["loss_rel_gap"] > P18_MOE_LOSS_TOL \
                or r["aux_rel_gap"] > P18_MOE_LOSS_TOL \
                or not r["dropped_equal"] or over \
                or r["experts_held"] != e // ep \
                or (r["cf"] < 1 and r["dropped_total"] == 0):
            bad.append(case)
        res[case] = r
    res["bad"] = bad
    return res, counts


def moe_ep(torch, card: str) -> tuple:
    """(b): the reference on one card, then dist_worker's ``chip_moe`` job
    on four Gloo ranks sharing the card, then (four cards) under NCCL, one
    rank a card. Returns (report, counts of the Gloo ranks' steps)."""
    from paddle_tpu_torch.testing import dist_worker as W
    inputs = moe_inputs(torch)
    refs, job_in = {}, dict(inputs)
    for cf in sorted({MOE_SWITCH["cf"]} | {s["cf"] for s in
                                           W.CHIP_MOE_CASES.values()
                                           if "cf" in s}):
        refs[cf], params = moe_reference(torch, inputs, cf)
        log(f"moe reference cf {cf} [{card}]: {json.dumps(refs[cf])}")
        job_in.update({f"ref{cf}/{k}": v for k, v in params.items()})
        del params
    job_in = {k: np.asarray(v) for k, v in job_in.items()}
    res = {"config": dict(MOE_SWITCH, batch=MOE_CHIP_BATCH,
                          t=MOE_CHIP_T, steps=MOE_CHIP_STEPS,
                          lr=MOE_CHIP_LR),
           "source": "Fedus et al. 2021, Switch-Base expert width",
           "reference": {str(cf): r for cf, r in refs.items()}}
    runs = [("gloo", "gloo")]
    n = torch.cuda.device_count()
    if n >= DIST_WORLD:
        runs.append(("nccl", "nccl"))
    else:
        res["nccl"] = {"ran": False, "why": (
            f"{n} CUDA device(s); the NCCL run needs {DIST_WORLD} (one "
            f"rank a card: run `python3 chip_smoke.py --zoo` on four "
            f"cards)")}
        log(f"phase 18 (b) NCCL not run: {res['nccl']['why']}")
    counts = None
    for tag, backend in runs:
        shutil.rmtree(P18_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        outs = W.run_job("chip_moe", P18_DIR, DIST_WORLD, job_in,
                         timeout_s=DIST_JOB_TIMEOUT_S,
                         env={"PT_WORKER_DEVICE": P18_DEVICE,
                              "PT_DIST_BACKEND": backend})
        job_s = time.perf_counter() - t0
        shutil.rmtree(P18_DIR, ignore_errors=True)
        r, c = check_moe_ranks(torch, outs, refs, backend)
        r["job_s"] = job_s
        res[tag] = r
        counts = c if counts is None else counts
        log(f"moe ep {tag} [{card}]: {json.dumps(r)}")
        if r["bad"]:
            raise AssertionError(f"moe ep {tag}: {r['bad']}")
    return res, counts


class RatingsNet:
    """A Movielens row (user id, gender, age, job, movie id, category)
    into RecommenderSystem's two towers (built in ``make``)."""

    @staticmethod
    def make(torch, device: str):
        from paddle_tpu_torch.models import RecommenderSystem
        from paddle_tpu_torch.nn import Layer

        class Ratings(Layer):
            def __init__(self) -> None:
                super().__init__()
                self.rec = RecommenderSystem(device=device, seed=SEED + 185)

            def forward(self, row):
                return self.rec(row[:, :4], row[:, 4:])

        return Ratings()


def rec_loss(pred, rating):
    return ((pred - rating) ** 2).mean()


def rec_fit(torch, card: str) -> tuple:
    """(c): RecommenderSystem at MovieLens-1M's widths through Model.fit
    on the synthetic Movielens, captured, Adam under fused_adam."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.data import DataLoader
    from paddle_tpu_torch.datasets import Movielens
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Adam
    restore = flag_scope({"fused_adam": True})
    try:
        ds = Movielens(mode="synthetic")
        net = RatingsNet.make(torch, P18_DEVICE)
        model = Model(net, loss=rec_loss, optimizer=Adam(REC_LR))
        rec = hapi_recorder(torch)
        kernels.reset_launch_counts()
        model.fit(DataLoader(ds, batch_size=REC_BATCH), epochs=1,
                  callbacks=[rec], verbose=0)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        losses = [float(v) for v in rec.losses]
        captures = model._train_step.captures
        del model, net
    finally:
        restore()
    res = {"rows": len(ds), "batch": REC_BATCH, "losses": losses,
           "captures": captures, "launches": nonzero(counts)}
    steps = len(ds) // REC_BATCH
    if len(losses) != steps or not all(np.isfinite(losses)) \
            or captures != 1 or counts.get("adam_leaf", 0) != steps:
        raise AssertionError(f"rec fit: {res}")
    return res, counts


def rec_card_against_cpu(torch) -> dict:
    """(c): both recommenders, one forward and backward on the card and on
    the CPU from the same weights (DeepFM's ReLU decisions shared:
    ``ReluSigns`` in place of its deep tower's ReLU module)."""
    from paddle_tpu_torch.datasets import Movielens
    from paddle_tpu_torch.models import DeepFM
    out = {}
    ds = Movielens(mode="synthetic")
    rows = torch.from_numpy(np.stack([ds[i][0] for i in range(len(ds))]))
    ratings = torch.from_numpy(np.stack([ds[i][1] for i in range(len(ds))]))
    card = RatingsNet.make(torch, P18_DEVICE)
    cpu = cpu_twin(torch, card, lambda d: RatingsNet.make(torch, d))

    def rec_run(m, dev):
        return rec_loss(m(rows.to(dev)), ratings.to(dev))

    lc, gc = p16_grads(torch, card, lambda m: rec_run(m, P18_DEVICE))
    lh, gh = p16_grads(torch, cpu, lambda m: rec_run(m, "cpu"))
    gaps = grad_gaps(torch, gc, gh)
    out["recommender"] = {"loss_rel_gap": abs(lc - lh) / abs(lh),
                          "grad_rel_gap_max": max(gaps.values()),
                          "rows": len(ds)}
    del card, cpu
    fields = [DEEPFM_IDS] * DEEPFM_FIELDS
    rng = np.random.default_rng(SEED + 186)
    x = torch.from_numpy(rng.integers(0, DEEPFM_IDS,
                                      (DEEPFM_BATCH, DEEPFM_FIELDS)))
    y = torch.from_numpy(rng.integers(0, 2, DEEPFM_BATCH))

    def make(dev):
        return DeepFM(fields, embed_dim=DEEPFM_EMBED, hidden=DEEPFM_HIDDEN,
                      device=dev, seed=SEED + 187)

    card = make(P18_DEVICE)
    cpu = cpu_twin(torch, card, make)
    signs = ReluSigns(torch)
    old = signs.install_children(card, signs.record)
    try:
        lc, gc = p16_grads(torch, card, lambda m: m.loss(
            x.to(P18_DEVICE), y.to(P18_DEVICE)))
    finally:
        ReluSigns.restore(old)
    old = signs.install_children(cpu, signs.replay)
    try:
        lh, gh = p16_grads(torch, cpu, lambda m: m.loss(x, y))
    finally:
        ReluSigns.restore(old)
    gaps = grad_gaps(torch, gc, gh)
    out["deepfm"] = {"loss_rel_gap": abs(lc - lh) / abs(lh),
                     "grad_rel_gap_max": max(gaps.values()),
                     "grad_rel_gap_worst_leaf": max(gaps, key=gaps.get),
                     "relu_flips": signs.flipped, "relu_units": signs.units,
                     "fields": DEEPFM_FIELDS, "ids": DEEPFM_IDS,
                     "batch": DEEPFM_BATCH,
                     "parameters": sum(p.numel() for p in card.parameters())}
    out["bounds"] = {"loss": P18_LOSS_TOL, "grad": P18_GRAD_TOL}
    log(f"recommenders card against cpu: {json.dumps(out)}")
    for name in ("recommender", "deepfm"):
        if out[name]["loss_rel_gap"] > P18_LOSS_TOL \
                or out[name]["grad_rel_gap_max"] > P18_GRAD_TOL:
            raise AssertionError(f"{name} card against cpu: {out[name]}")
    return out


def ptb_tar(path: str, seed: int) -> None:
    """A PTB-format ``simple-examples.tgz``: seeded ASCII words."""
    import io
    import tarfile
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]

    def text(lines: int) -> str:
        return "".join(" ".join(words[j] for j in rng.zipf(1.3, 12) % 300)
                       + "\n" for _ in range(lines))

    with tarfile.open(path, "w:gz") as tar:
        for name, body in (("./simple-examples/data/ptb.train.txt",
                            text(2000)),
                           ("./simple-examples/data/ptb.valid.txt",
                            text(100))):
            data = body.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def data_path(torch, card: str) -> dict:
    """(d): the Tokenizer round trip, Imikolov through both tokenizer
    paths, a reader chain feeding a training loop on the card, and every
    distribution card against CPU."""
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch import reader
    from paddle_tpu_torch.datasets import Imikolov
    from paddle_tpu_torch.models import NGramLM
    from paddle_tpu_torch.native import Tokenizer
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import TrainStep
    res = {}
    shutil.rmtree(P18_DIR, ignore_errors=True)
    os.makedirs(P18_DIR)
    try:
        corpus = os.path.join(P18_DIR, "corpus.txt")
        rng = np.random.default_rng(SEED + 188)
        with open(corpus, "w") as f:
            for _ in range(5000):
                f.write(" ".join(f"t{j}" for j in rng.zipf(1.5, 10) % 2000)
                        + "\n")
        t0 = time.perf_counter()
        with Tokenizer.build([corpus], min_freq=2) as tok:
            build_s = time.perf_counter() - t0
            ids = tok.encode_file(corpus, unk_id=0)
            vocab = tok.freqs()
            tok.save(os.path.join(P18_DIR, "v.vocab"))
            size = len(tok)
        with Tokenizer.load(os.path.join(P18_DIR, "v.vocab")) as back:
            same = len(back) == size and bool(np.array_equal(
                back.encode_file(corpus, unk_id=0), ids))
        res["tokenizer"] = {"vocab": size, "tokens": int(len(ids)),
                            "top_freq": int(vocab[0]), "build_s": build_s,
                            "round_trip_equal": same}
        ptb_tar(os.path.join(P18_DIR, "simple-examples.tgz"), SEED + 189)
        kw = dict(mode="train", window_size=5, min_word_freq=2,
                  data_home=P18_DIR)
        py = Imikolov(**kw)
        nat = Imikolov(**kw, use_native_tokenizer=True)
        imik_equal = py.word_idx == nat.word_idx and bool(
            np.array_equal(py.ctx, nat.ctx)) and bool(
            np.array_equal(py.nxt, nat.nxt))
        res["imikolov"] = {"vocab": len(py.word_idx), "ngrams": len(py),
                           "native_equals_python": imik_equal}
        # a reader chain (threaded map, prefetch buffer, batches) feeding
        # an N-gram LM's steps on the card
        lm = NGramLM(len(py.word_idx), embed_dim=32, context=4,
                     hidden=128, device=P18_DEVICE, seed=SEED + 190)
        step = TrainStep(lm, SGD(0.5), lambda o, t: _xent(o, t),
                         compiled=False)
        chain = reader.batch(reader.buffered(reader.xmap_readers(
            lambda i: (py.ctx[i], py.nxt[i]),
            lambda: iter(range(min(len(py), 64 * 40))), 4, 64), 256), 64)
        losses = []
        for b in chain():
            ctx = torch.from_numpy(np.stack([c for c, _ in b])).to(
                P18_DEVICE)
            nxt = torch.from_numpy(np.asarray([t for _, t in b])).to(
                P18_DEVICE)
            losses.append(float(step(ctx, labels=(nxt,))["loss"]))
        res["reader_loop"] = {"batches": len(losses), "first": losses[0],
                              "last": losses[-1]}
    finally:
        shutil.rmtree(P18_DIR, ignore_errors=True)
    # the distributions on the card against the CPU
    rng = np.random.default_rng(SEED + 191)
    loc = rng.standard_normal((64, 8)).astype(np.float32)
    scale = (rng.random((64, 8)) + 0.5).astype(np.float32)
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    value = (rng.standard_normal((64, 8)) * 2).astype(np.float32)
    cls = rng.integers(0, 10, 64)

    def family(dev):
        return {"uniform": D.Uniform(loc - 1, loc + scale, device=dev),
                "normal": D.Normal(loc, scale, device=dev),
                "categorical": D.Categorical(logits, device=dev),
                "mvn": D.MultivariateNormalDiag(loc, scale, device=dev),
                "normal2": D.Normal(loc * 0.5, scale * 2, device=dev)}

    gaps = {}
    cards, cpus = family(P18_DEVICE), family("cpu")
    for name in ("uniform", "normal", "categorical", "mvn"):
        v = cls if name == "categorical" else value
        for what in ("log_prob", "entropy"):
            a = getattr(cards[name], what)(*([v] if what == "log_prob"
                                             else []))
            b = getattr(cpus[name], what)(*([v] if what == "log_prob"
                                            else []))
            fin = torch.isfinite(b)
            same_inf = bool(torch.equal(torch.isfinite(a).cpu(), fin))
            gaps[f"{name}.{what}"] = rel_gap(torch, a.cpu()[fin], b[fin]) \
                if same_inf else float("inf")
    gaps["kl(normal, normal2)"] = rel_gap(
        torch, D.kl_divergence(cards["normal"], cards["normal2"]),
        D.kl_divergence(cpus["normal"], cpus["normal2"]))
    draws = cards["normal"].sample((1000,), key=SEED)
    res["distributions"] = {"rel_gaps": gaps, "bound": DIST_TOL,
                            "sample_device": str(draws.device),
                            "sample_shape": list(draws.shape)}
    log(f"data path [{card}]: {json.dumps(res)}")
    if not res["tokenizer"]["round_trip_equal"] \
            or not res["imikolov"]["native_equals_python"] \
            or not all(np.isfinite(losses)) or losses[-1] >= losses[0] \
            or max(gaps.values()) > DIST_TOL \
            or draws.device.type != torch.device(P18_DEVICE).type:
        raise AssertionError(f"data path: {res}")
    return res


def _xent(out, target):
    from paddle_tpu_torch.ops.loss import cross_entropy
    return cross_entropy(out, target)


def run_phase18(torch) -> tuple:
    """Phase 18. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts, failed = {}, {}, []
    report["txl_fit"], counts["txl"] = txl_fit(torch, card)
    # each later check runs whatever an earlier one found; the phase
    # raises at its end, naming every check that failed
    for name, check in (("moe_ep", moe_ep), ("rec_fit", rec_fit)):
        torch.cuda.empty_cache()
        try:
            report[name], counts[name] = check(torch, card)
        except AssertionError as e:
            log(f"phase 18 {name} FAILED: {e}")
            failed.append(name)
    for name, check in (("recommenders_card_against_cpu",
                         lambda torch, card: rec_card_against_cpu(torch)),
                        ("data_path", data_path)):
        torch.cuda.empty_cache()
        try:
            report[name] = check(torch, card)
        except AssertionError as e:
            log(f"phase 18 {name} FAILED: {e}")
            failed.append(name)
    report["phase18_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {report['phase18_s']:.1f} s [{card}]")
    if failed:
        raise AssertionError(f"phase 18: {failed} failed (see the log)")
    return report, counts


# --------------------------------------------------------------------------
# phase 19: the compat slice (layers/fluid shims, slim, auto_checkpoint,
# sysconfig, nn.functional) over BERT-base
# --------------------------------------------------------------------------

P19_DEVICE = "cuda"
COMPAT_BATCH, COMPAT_SEQ, COMPAT_STEPS, COMPAT_EPOCHS = 8, 512, 4, 2
COMPAT_DIR = "chip_smoke_compat"  # slot files and checkpoints (removed)
# fluid.layers.exponential_decay(1e-4, decay_steps 2, rate 0.9, staircase)
COMPAT_LR = dict(learning_rate=1e-4, decay_steps=2, decay_rate=0.9,
                 staircase=True)
# (b): 2 layers at the full widths, batch 2, card against CPU with the
# card's round decisions shared (RoundShare). A flipped decision must lie
# within rounding of a half step (|frac - 0.5| <= QAT_TIE: the pre-round
# value is x / scale * 127, |x / scale| <= 1, so fp32 rounding moves it
# by ~127 * 2^-23 per operation); loss and gradients as the fp32 card
# against CPU checks of phase 18
QAT_CPU_LAYERS, QAT_CPU_BATCH = 2, 2
QAT_TIE = 1e-3
QAT_LOSS_TOL, QAT_GRAD_TOL = 1e-5, 1e-4
# (c): the int8 MLM logits against the fake-quant model's eval logits, the
# JAX test's bound (tests/test_detection_slim.py: mean |gap| < 0.05 x
# mean |logit|); the calibration batches
INT8_LOGIT_BOUND = 0.05
PTQ_BATCHES = 2
# (c): the Int8Linear layers whose int32 accumulators are held bit for
# bit against the CPU: a square one, the pooler (M = batch, padded to
# torch._int_mm's 17 rows) and the NSP head (N = 2, padded to 8)
INT8_LAYERS = ("bert.encoder.layers.0.linear1", "bert.pooler",
               "cls.seq_relationship")
# (d): F.multihead_matmul at BERT-base's shape (12 heads of 64 at s 512:
# the eval gate takes the plain composition) and at 8192 keys, where the
# gate admits the flash forward at head dim 64
MHM_SHAPES = ((8, 512, 768, 12), (1, 8192, 768, 12))
PATH_KERNELS.update({
    "compat_qat": ("layer_norm", "flash_attention_fwd",
                   "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                   "fused_xent_fwd", "fused_xent_bwd_dlog",
                   "fused_xent_bwd_dh", "fused_xent_bwd_dw", "adam_leaf"),
    # eval at s 512, head dim 64: the plain attention route, LayerNorm's
    # kernel alone
    "compat_int8": ("layer_norm",),
    "compat_mhm": ("flash_attention_fwd",)})


def compat_config(layers: int = 12):
    from paddle_tpu_torch.models import bert_base_config
    cfg = bert_base_config()
    cfg.num_hidden_layers = layers
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def compat_model(torch, device: str, layers: int = 12, seed: int = SEED):
    """BertForPretraining at ``bert_base_config`` (dropout 0), every Linear
    wrapped by ``slim.quantize_model``."""
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.models import BertForPretraining
    model = BertForPretraining(compat_config(layers), device=device,
                               seed=seed)
    return slim.quantize_model(model)


def compat_slot_files(directory: str, vocab: int) -> list:
    """COMPAT_STEPS batches of seeded records as two MultiSlot files
    (slots: input_ids, mlm with every position labelled, nsp)."""
    n = COMPAT_BATCH * COMPAT_STEPS
    rng = np.random.default_rng(SEED + 19)
    ids = rng.integers(0, vocab, (n, COMPAT_SEQ))
    mlm = rng.integers(0, vocab, (n, COMPAT_SEQ))
    nsp = rng.integers(0, 2, (n, 1))
    os.makedirs(directory, exist_ok=True)
    files = []
    for part in range(2):
        path = os.path.join(directory, f"part-{part}")
        with open(path, "w") as f:
            for i in range(part * n // 2, (part + 1) * n // 2):
                f.write(" ".join(f"{len(v)} " + " ".join(map(str, v))
                                 for v in (ids[i], mlm[i], nsp[i]))
                        + "\n")
        files.append(path)
    return files


def compat_dataset(files: list):
    from paddle_tpu_torch.data import InMemoryDataset
    ds = InMemoryDataset()
    ds.set_slots([("input_ids", "sparse", COMPAT_SEQ),
                  ("mlm", "sparse", COMPAT_SEQ), ("nsp", "sparse", 1)])
    ds.set_batch_size(COMPAT_BATCH)
    ds.set_thread(1)
    ds.set_filelist(files)
    loaded = ds.load_into_memory()
    if loaded != COMPAT_BATCH * COMPAT_STEPS:
        raise AssertionError(f"compat: loaded {loaded} records")
    return ds


def compat_loss(out, mlm, nsp):
    from paddle_tpu_torch.models import pretraining_loss
    return pretraining_loss(out, mlm, nsp.reshape(-1))


def compat_step(torch, model, compiled: bool):
    """A TrainStep with Adam at the fluid.layers decay."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import TrainStep
    lr = fluid.layers.exponential_decay(**COMPAT_LR)
    return TrainStep(model, Adam(lr), compat_loss, seed=SEED,
                     compiled=compiled)


def act_scales(model) -> dict:
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers()
            if n.endswith("act_scale")}


def compat_fit(torch, step, ds, epochs, save_dir: str, handler=None):
    """``fluid.Executor(fluid.CUDAPlace(0)).train_from_dataset`` an epoch
    at a time inside ``incubate.train_epoch_range`` (the step's whole
    state registered), under ``fluid.scope_guard``. Returns (the
    range's start epoch, the per-epoch mean losses)."""
    from paddle_tpu_torch import fluid, incubate
    history = []
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        r = incubate.train_epoch_range(epochs, save_dir=save_dir,
                                       name="qat")
        r.register("train", step.state_dict, step.set_state_dict)
        for _ in r:
            history += exe.train_from_dataset(
                step, ds, input_slots=["input_ids"],
                label_slots=["mlm", "nsp"], epochs=1,
                fetch_handler=handler)
    return r.start_epoch, history


def compat_qat(torch, card: str) -> tuple:
    """(a): QAT BERT-base through the fluid spellings, its eager twin, a
    resumed run and the Scope round trip."""
    from paddle_tpu_torch import fluid, kernels
    from paddle_tpu_torch.kernels.fused_softmax_xent import bwd_chunk
    cfg = compat_config()
    root = os.path.abspath(COMPAT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    ds = compat_dataset(compat_slot_files(os.path.join(root, "slots"),
                                          cfg.vocab_size))
    batches = [tuple(torch.from_numpy(b[k]).to(P19_DEVICE)
                     for k in ("input_ids", "mlm", "nsp")) for b in ds]
    restore = flag_scope(FUSED_FLAGS)
    try:
        model = compat_model(torch, P19_DEVICE)
        n_q = sum(type(m).__name__ == "QuantizedLinear"
                  for m in model.modules())
        step = compat_step(torch, model, compiled=True)
        losses, events = [], []

        def handler(metrics):
            losses.append(metrics["loss"])
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        start, history = compat_fit(torch, step, ds, COMPAT_EPOCHS,
                                    os.path.join(root, "full"), handler)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(v) for v in losses]
        captures = step.captures
        scales = act_scales(model)
        final = state_on_host(step)
        # the scope round trip of the trained parameters and act_scales
        scope = fluid.Scope()
        for n, t in list(model.named_parameters()) + [
                (n, b) for n, b in model.named_buffers()
                if n.endswith("act_scale")]:
            scope.set_var(n, t.detach())
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            fluid.io.save_persistables(exe, os.path.join(root, "scope"))
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            fluid.io.load_persistables(fluid.Executor(fluid.CUDAPlace(0)),
                                       os.path.join(root, "scope"))
        scope_bad = [n for n in scope.local_var_names()
                     if not torch.equal(fresh.find_var(n),
                                        scope.find_var(n))]
        scope_vars = len(scope.local_var_names())
        del step, model, scope, fresh
        torch.cuda.empty_cache()
        # the eager twin: the same model, seed and batches, step by step
        eager_model = compat_model(torch, P19_DEVICE)
        eager = compat_step(torch, eager_model, compiled=False)
        eager_losses = []
        for _ in range(COMPAT_EPOCHS):
            for ids, mlm, nsp in batches:
                eager_losses.append(eager(ids, labels=(mlm, nsp))["loss"])
        eager_losses = [float(v) for v in eager_losses]
        eager_scales = act_scales(eager_model)
        del eager, eager_model
        torch.cuda.empty_cache()
        # interrupted after epoch 1, resumed by a fresh range (a model of
        # another seed: the restore must bring every leaf back)
        part = os.path.join(root, "resume")
        first = compat_step(torch, compat_model(torch, P19_DEVICE),
                            compiled=True)
        compat_fit(torch, first, ds, 1, part)
        del first
        torch.cuda.empty_cache()
        resumed_model = compat_model(torch, P19_DEVICE, seed=SEED + 1)
        resumed = compat_step(torch, resumed_model, compiled=True)
        resumed_start, _ = compat_fit(torch, resumed, ds, COMPAT_EPOCHS,
                                      part)
        resumed_bad = equal_states(torch, state_on_host(resumed), final)
        del resumed, resumed_model
    finally:
        restore()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    steps = COMPAT_EPOCHS * COMPAT_STEPS
    rows = COMPAT_BATCH * COMPAT_SEQ
    d = cfg.hidden_size // cfg.num_attention_heads
    per_step = expected_launches(COMPAT_SEQ, cfg.num_hidden_layers, d,
                                 FUSED_FLAGS, rows=rows,
                                 vocab=cfg.vocab_size)
    # within an epoch (the epoch's checkpoint sits between two), after
    # the first step (its warm-up and capture)
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(2, len(events)) if i % COMPAT_STEPS]
    step_ms = float(np.median(ms))
    scale_bad = [n for n in scales if not torch.equal(scales[n],
                                                      eager_scales[n])]
    res = {"config": {k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size")},
        "batch": COMPAT_BATCH, "seq": COMPAT_SEQ, "dtype": "float32",
        "flags": FUSED_FLAGS, "lr": COMPAT_LR, "quantized_linears": n_q,
        "epochs": COMPAT_EPOCHS, "steps": steps, "fit_s": fit_s,
        "start_epoch": start, "epoch_losses": history, "losses": losses,
        "eager_losses": eager_losses,
        "losses_bit_for_bit_with_eager": losses == eager_losses,
        "act_scales": len(scales), "act_scales_not_equal": scale_bad,
        "resumed_start_epoch": resumed_start,
        "resumed_leaves_not_equal": resumed_bad[:8],
        "scope_vars": scope_vars, "scope_round_trip_not_equal": scope_bad,
        "captures": captures, "step_stream_ms": ms,
        "step_ms_median_after_capture": step_ms,
        "tokens_per_s": rows / step_ms * 1e3, "peak_allocated_gb": peak,
        "xent_bwd_chunks": -(-cfg.vocab_size // bwd_chunk(
            rows, cfg.vocab_size)),
        "launches_per_step": nonzero(per_step), "card": card}
    log(f"compat qat fit [{card}]: {json.dumps(res)}")
    if n_q != cfg.num_hidden_layers * 6 + 3:
        raise AssertionError(f"compat: {n_q} QuantizedLinears")
    if not all(np.isfinite(losses)) or losses != eager_losses:
        raise AssertionError(f"compat: captured losses {losses} against "
                             f"eager {eager_losses}")
    if scale_bad or len(scales) != n_q:
        raise AssertionError(f"compat: act_scales differ from eager: "
                             f"{scale_bad[:8]} ({len(scales)})")
    if captures != 1 or start != 0:
        raise AssertionError(f"compat: {captures} captures over {steps} "
                             f"steps of one shape, start epoch {start}")
    if resumed_start != 1 or resumed_bad:
        raise AssertionError(f"compat: resumed at epoch {resumed_start}; "
                             f"leaves differ from the uninterrupted run: "
                             f"{resumed_bad[:8]}")
    n_params = sum(k.startswith("params/") for k in final)
    if scope_bad or scope_vars != n_params + n_q:
        raise AssertionError(f"compat: scope round trip {scope_vars} "
                             f"vars, differing {scope_bad[:8]}")
    path_launches("compat_qat", counts, per_step, steps)
    return res, counts


class RoundShare:
    """The fake-quant round decisions of one forward, shared with another
    run of the same model, as ``ReluSigns`` shares ReLU's: ``record`` (on
    the card) keeps each ``round`` result in call order, ``replay`` (on
    the CPU) returns the recorded one and counts the entries whose own
    rounding differs, each of which must lie within ``QAT_TIE`` of a half
    step. The gradient passes straight through in both."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.grids: list = []
        self.pos = 0
        self.flipped = 0
        self.entries = 0
        self.worst_tie = 0.0

    def record(self, x):
        from paddle_tpu_torch import slim
        q = slim._STERound.apply(x)
        self.grids.append(q.detach().to(self.torch.int8).cpu())
        return q

    def replay(self, x):
        torch = self.torch
        card = self.grids[self.pos].to(x.dtype)
        self.pos += 1
        own = torch.round(x.detach())
        flip = own != card
        self.entries += flip.numel()
        if bool(flip.any()):
            frac = (x.detach()[flip] - torch.floor(x.detach()[flip]))
            tie = float((frac - 0.5).abs().max())
            self.worst_tie = max(self.worst_tie, tie)
            self.flipped += int(flip.sum())
        return x + (card - x).detach()


def qat_card_against_cpu(torch) -> dict:
    """(b): 2 layers at the full widths, batch 2, one QAT forward and
    backward (training mode: the act_scale EMA moves) on the card and on
    the CPU from the same weights, the card's round decisions shared."""
    import copy
    from paddle_tpu_torch import slim
    cpu = compat_model(torch, "cpu", QAT_CPU_LAYERS)
    card = copy.deepcopy(cpu).to(P19_DEVICE)
    ids, mlm, nsp = bert_batch(torch, compat_config(QAT_CPU_LAYERS),
                               QAT_CPU_BATCH, COMPAT_SEQ, "cpu", SEED + 191)
    share = RoundShare(torch)
    orig = slim._ste_round
    restore = flag_scope(FUSED_FLAGS)
    t0 = time.perf_counter()
    try:
        slim._ste_round = share.record
        lc, gc = p16_grads(torch, card, lambda m: compat_loss(
            m(ids.to(P19_DEVICE)), mlm.to(P19_DEVICE), nsp.to(P19_DEVICE)))
        slim._ste_round = share.replay
        lh, gh = p16_grads(torch, cpu, lambda m: compat_loss(
            m(ids), mlm, nsp))
    finally:
        slim._ste_round = orig
        restore()
    plain = {n.replace(".inner.", "."): g for n, g in gc.items()}
    gaps = grad_gaps(torch, plain, {n.replace(".inner.", "."): g
                                    for n, g in gh.items()})
    sc, sh = act_scales(card), act_scales(cpu)
    scale_gap = max(float((sc[n] - sh[n]).abs() / sh[n]) for n in sc)
    res = {"loss_card": lc, "loss_cpu": lh,
           "loss_rel_gap": abs(lc - lh) / abs(lh),
           "grad_rel_gap_max": max(gaps.values()),
           "grad_rel_gap_worst_leaf": max(gaps, key=gaps.get),
           "act_scale_rel_gap_max": scale_gap,
           "round_calls": share.pos, "round_entries": share.entries,
           "round_flips": share.flipped, "worst_flip_tie": share.worst_tie,
           "bounds": {"loss": QAT_LOSS_TOL, "grad": QAT_GRAD_TOL,
                      "tie": QAT_TIE},
           "layers": QAT_CPU_LAYERS, "batch": QAT_CPU_BATCH,
           "both_s": time.perf_counter() - t0}
    log(f"compat qat card against cpu: {json.dumps(res)}")
    if share.pos != len(share.grids) or share.worst_tie > QAT_TIE:
        raise AssertionError(f"compat (b): round decisions {share.pos} of "
                             f"{len(share.grids)}, a flip {share.worst_tie}"
                             f" from a half step")
    if not (res["loss_rel_gap"] <= QAT_LOSS_TOL
            and res["grad_rel_gap_max"] <= QAT_GRAD_TOL
            and scale_gap <= QAT_LOSS_TOL):
        raise AssertionError(f"compat (b): card against CPU {res}")
    return res


def compat_int8(torch, card: str) -> tuple:
    """(c): PostTrainingQuantization on PTQ_BATCHES eval batches,
    convert_to_int8, the int8 BERT-base forward; the chosen layers'
    int32 accumulators against the CPU's; the fp32, fake-quant and int8
    forwards' ms."""
    import copy
    from paddle_tpu_torch import kernels, slim
    from paddle_tpu_torch.models import BertForPretraining
    cfg = compat_config()
    model = BertForPretraining(cfg, device=P19_DEVICE, seed=SEED)
    model.eval()
    ids = [bert_batch(torch, cfg, COMPAT_BATCH, COMPAT_SEQ, P19_DEVICE,
                      SEED + 192 + i)[0] for i in range(PTQ_BATCHES + 1)]
    with torch.no_grad():
        fp32_ms = device_ms(torch, lambda: model(ids[-1]), 5)
        slim.quantize_model(model)
        model.eval()  # the wrappers are made in training mode
        ptq = slim.PostTrainingQuantization(model).calibrate(
            [(x,) for x in ids[:PTQ_BATCHES]])
        want = model(ids[-1])[0]
        fq_ms = device_ms(torch, lambda: model(ids[-1]), 5)
        slim.convert_to_int8(model)
        layers = dict(model.named_modules())
        inputs = {}
        hooks = [layers[n].register_forward_pre_hook(
            lambda m, a, n=n: inputs.__setitem__(n, a[0].detach()))
            for n in INT8_LAYERS]
        kernels.reset_launch_counts()
        got = model(ids[-1])[0]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for h in hooks:
            h.remove()
        int8_ms = device_ms(torch, lambda: model(ids[-1]), 5)
        acc = {}
        for n in INT8_LAYERS:
            lay = layers[n]
            twin = copy.deepcopy(lay).to("cpu")
            a_card = lay.accumulate(inputs[n])
            a_cpu = twin.accumulate(inputs[n].cpu())
            acc[n] = {"shape": list(a_card.shape),
                      "dtype": str(a_card.dtype).replace("torch.", ""),
                      "bit_for_bit": bool(torch.equal(a_card.cpu(), a_cpu)),
                      "abs_max": int(a_cpu.abs().max())}
    n_int8 = sum(type(m).__name__ == "Int8Linear" for m in model.modules())
    gap = float((got - want).abs().mean() / want.abs().mean())
    res = {"ptq_batches": PTQ_BATCHES,
           "ptq_output_abs_max": ptq.act_scales["output"],
           "int8_linears": n_int8, "int8_mean_abs_gap_rel": gap,
           "bound": INT8_LOGIT_BOUND, "accumulators": acc,
           "fp32_forward_ms": fp32_ms, "fake_quant_forward_ms": fq_ms,
           "int8_forward_ms": int8_ms, "batch": COMPAT_BATCH,
           "seq": COMPAT_SEQ, "card": card}
    log(f"compat int8 [{card}]: {json.dumps(res)}")
    del model
    torch.cuda.empty_cache()
    if n_int8 != cfg.num_hidden_layers * 6 + 3 or not all(a["bit_for_bit"]
                                       and a["dtype"] == "int32"
                                       for a in acc.values()):
        raise AssertionError(f"compat (c): {n_int8} Int8Linears, "
                             f"accumulators {acc}")
    if not (bool(torch.isfinite(got).all()) and gap < INT8_LOGIT_BOUND):
        raise AssertionError(f"compat (c): int8 logits {gap} of the mean "
                             f"|logit| from the fake-quant model's")
    return res, counts


def compat_multihead_matmul(torch) -> tuple:
    """(d): F.multihead_matmul against its plain version (the projection,
    then ops.attention's composition) at MHM_SHAPES; the flash forward
    launches once where the gate admits the call, never where not."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
    out, counts = {}, None
    for b, t, c, h in MHM_SHAPES:
        g = torch.Generator(device=P19_DEVICE).manual_seed(SEED + t)
        x = torch.randn(b, t, c, device=P19_DEVICE, generator=g)
        w = torch.randn(c, 3 * c, device=P19_DEVICE, generator=g) * c ** -0.5
        bias = torch.randn(3 * c, device=P19_DEVICE, generator=g) * 0.1
        kernels.reset_launch_counts()
        got = F.multihead_matmul(x, w, bias, h)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        qkv = (x @ w + bias).reshape(b, t, 3, h, c // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        want = scaled_dot_product_attention(q, k, v).transpose(1, 2) \
            .reshape(b, t, c)
        err = float((got - want).abs().max())
        ms = device_ms(torch, lambda: F.multihead_matmul(x, w, bias, h), 5)
        flash = launched["flash_attention_fwd"]
        out[f"b{b}_t{t}_c{c}_h{h}"] = {
            "max_abs_err": err, "flash_attention_fwd": flash, "ms": ms,
            "tol": FLASH_TOL}
        if err > FLASH_TOL or flash != (1 if t >= 8192 else 0):
            raise AssertionError(f"compat (d): multihead_matmul at "
                                 f"{(b, t, c, h)}: err {err}, flash "
                                 f"launches {flash}")
        if flash:
            counts = launched
        del x, w, q, k, v, qkv, got, want
        torch.cuda.empty_cache()
    log(f"compat multihead_matmul: {json.dumps(out)}")
    return out, counts


def compat_sysconfig(torch) -> dict:
    """(e): a fresh FLAGS_compile_cache_dir: the first process compiles
    the layer_norm library there (misses), a second loads it (hits, no
    miss); get_include and get_lib name directories that exist."""
    from paddle_tpu_torch import sysconfig
    cache = os.path.abspath(COMPAT_DIR + "_cache")
    shutil.rmtree(cache, ignore_errors=True)
    code = ("import json; from paddle_tpu_torch.kernels import _build; "
            "from paddle_tpu_torch import sysconfig; "
            "_build.build_all(['layer_norm']); "
            "print(json.dumps(sysconfig.compile_cache_stats()))")
    env = dict(os.environ, FLAGS_compile_cache_dir=cache,
               PYTHONPATH=os.getcwd())
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"compat (e): rc {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(stats, s=time.perf_counter() - t0))
    built = sorted(os.listdir(cache))
    shutil.rmtree(cache, ignore_errors=True)
    inc, lib = sysconfig.get_include(), sysconfig.get_lib()
    res = {"runs": runs, "built": built, "include": inc, "lib": lib,
           "include_has_header": os.path.isfile(
               os.path.join(inc, "ptnative.h")),
           "lib_has_library": os.path.isfile(
               os.path.join(lib, "libptnative.so"))}
    log(f"compat sysconfig: {json.dumps(res)}")
    first, second = runs
    if not (first["misses"] > 0 and second["hits"] > 0
            and second["misses"] == 0 and res["include_has_header"]
            and res["lib_has_library"]):
        raise AssertionError(f"compat (e): {res}")
    return res


def run_phase19(torch) -> tuple:
    """Phase 19. Returns (report, launch counts of each path)."""
    card = REPORT.get("card", "")
    t_phase = time.perf_counter()
    report, counts, failed = {}, {}, []
    report["compat_qat"], counts["compat_qat"] = compat_qat(torch, card)
    # each later check runs whatever an earlier one found; the phase
    # raises at its end, naming every check that failed
    for name, check in (
            ("compat_qat_card_against_cpu",
             lambda: (qat_card_against_cpu(torch), None)),
            ("compat_int8", lambda: compat_int8(torch, card)),
            ("compat_mhm", lambda: compat_multihead_matmul(torch)),
            ("compat_sysconfig", lambda: (compat_sysconfig(torch), None))):
        torch.cuda.empty_cache()
        try:
            report[name], got = check()
            if got is not None:
                counts[name] = got
        except AssertionError as e:
            log(f"phase 19 {name} FAILED: {e}")
            failed.append(name)
    report["phase19_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {report['phase19_s']:.1f} s [{card}]")
    if failed:
        raise AssertionError(f"phase 19: {failed} failed (see the log)")
    return report, counts


def kernel_line(results: dict, counts: dict) -> dict:
    """The kernels JSON line. ``launches`` is the count from the run of
    the kernel's own path, or, where ``path`` lists several, the sum of
    their counts, each read from its own run with the counts reset just
    before it; ``launches_by_path`` gives every path's."""
    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_ref = "paddle_tpu/kernels/flash_attention.py"
    xent_src = "paddle_tpu_torch/csrc/fused_softmax_xent.cu"
    xent_ref = "paddle_tpu/kernels/fused_softmax_xent.py"
    adam_src = "paddle_tpu_torch/csrc/fused_adam.cu"
    adam_ref = "paddle_tpu/kernels/fused_adam.py"
    meta = {
        # phase 18 (a)'s Transformer-XL steps and phase 19 (a)'s QAT
        # BERT-base steps launch it too: they add
        "layer_norm": (("serving", "txl", "compat_qat"),
                       "paddle_tpu_torch/csrc/layer_norm.cu",
                       "paddle_tpu/kernels/layer_norm.py:29"),
        "paged_attention": ("serving",
                            "paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/kernels/paged_attention.py:55"),
        "paged_attention_multiquery": (
            "speculative", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/paged_attention.py:185"),
        "flash_attention_fwd": ("train_seq512", flash_src,
                                f"{flash_ref}:128"),
        "flash_attention_bwd_fused": ("train_seq128", flash_src,
                                      f"{flash_ref}:541"),
        "flash_attention_bwd_dq": ("train_seq512", flash_src,
                                   f"{flash_ref}:417"),
        "flash_attention_bwd_dkv": ("train_seq512", flash_src,
                                    f"{flash_ref}:473"),
        "fused_xent_fwd": ("train_seq512_fused", xent_src,
                           f"{xent_ref}:69"),
        # the recompute _backward's two kernels each repeat, done once
        "fused_xent_bwd_dlog": ("train_seq512_fused", xent_src,
                                f"{xent_ref}:176"),
        "fused_xent_bwd_dh": ("train_seq512_fused", xent_src,
                              f"{xent_ref}:92"),
        "fused_xent_bwd_dw": ("train_seq512_fused", xent_src,
                              f"{xent_ref}:110"),
        # phase 16 (b)'s CRNN steps, phase 17 (a)'s MobileNetV2 steps,
        # phase 18's Transformer-XL, expert-parallel MoE and recommender
        # steps and phase 19 (a)'s QAT BERT-base steps launch it too:
        # their launches add
        "adam_leaf": (("train_seq512_fused", "crnn_ctc_fit", "mv2_fit",
                       "txl", "moe_ep", "rec_fit", "compat_qat"),
                      adam_src, f"{adam_ref}:54"),
        "adam_flat": ("train_seq128_pallas_adam", adam_src,
                      f"{adam_ref}:34"),
        # an entry over the flash kernels (forward, dq + dkv or fused):
        # its launches are theirs on its own path
        "flash_attention_with_lse": (
            "flash_with_lse", "paddle_tpu_torch/kernels/flash_attention.py",
            f"{flash_ref}:807", PATH_KERNELS["flash_with_lse"]),
    }
    for path, names in PATH_KERNELS.items():
        for name in names:
            if counts[path][name] <= 0:
                raise AssertionError(f"kernel {name} was never launched "
                                     f"on the {path} path")
    line = []
    for name, (path, src, replaces, *counters) in meta.items():
        counters = counters[0] if counters else (name,)
        paths = path if isinstance(path, tuple) else (path,)
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "path": path,
                     "launches": sum(counts[p][c] for p in paths
                                     for c in counters),
                     "launches_by_path": {p: sum(counts[p][c]
                                                 for c in counters)
                                          for p in PATH_KERNELS},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
        if name in DESIGNS:
            line[-1]["design"] = DESIGNS[name]
    return {"kernels": line}


def main(argv=None) -> int:
    """The whole smoke (no arguments), or with ``--distributed`` phases 13
    and 14 alone (the kernels built; 14 (b) needs four cards)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--distributed", action="store_true",
                    help="run phases 13-14 only (parallelism; on four "
                         "cards phase 14 (b) runs under NCCL)")
    ap.add_argument("--static", action="store_true",
                    help="run phase 15 only (the static programming model "
                         "and the core op library)")
    ap.add_argument("--recurrent", action="store_true",
                    help="run phase 16 only (the recurrent and sequence "
                         "stack)")
    ap.add_argument("--vision", action="store_true",
                    help="run phase 17 only (the vision slice)")
    ap.add_argument("--zoo", action="store_true",
                    help="run phase 18 only (MoE with expert parallelism, "
                         "Transformer-XL, the recommenders and the data "
                         "modules)")
    ap.add_argument("--compat", action="store_true",
                    help="run phase 19 only (nn.functional, the layers/ "
                         "and fluid/ shims, slim with int8 deployment, "
                         "auto_checkpoint and sysconfig over BERT-base)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from paddle_tpu_torch import native
    from paddle_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    REPORT["card"] = card
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the serving transport's library (g++) builds beside the kernels
        native_s = pool.submit(timed, native.build)
        _build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
        log(f"native build: {native_s.result():.1f} s (g++, csrc/*.cc)")
    for name, text in sorted(_build.build_logs.items()):
        func = ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                # the kernel's name and template arguments, unmangled
                m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?)?",
                              ln)
                func = m.group(1) + "".join(f"<{a}>" for a in m.groups()[1:]
                                            if a) if m else ln
            elif "registers" in ln or "spill" in ln or "error" in ln:
                log(f"ptxas {name} {func}: {ln.strip()}")

    PATH_KERNELS.update(dist14_path_kernels())
    if args.distributed:
        return main_distributed(torch, card, t_start)
    if args.static:
        return main_static(torch, card, t_start)
    if args.recurrent:
        return main_recurrent(torch, card, t_start)
    if args.vision:
        return main_vision(torch, card, t_start)
    if args.zoo:
        return main_zoo(torch, card, t_start)
    if args.compat:
        return main_compat(torch, card, t_start)

    timer = Timer(torch)
    results = check_kernels(torch, timer)
    results.update(check_flash(torch, timer))
    results["flash_attention_with_lse"], lse_counts = check_flash_lse(
        torch, timer)
    results.update(check_fused_xent(torch, timer))
    results.update(check_fused_adam(torch, timer))
    ln_bwd = check_layer_norm_backward(torch, timer)
    results["layer_norm"]["max_abs_err"] = max(
        results["layer_norm"]["max_abs_err"], ln_bwd["forward_max_abs_err"])
    bf16 = check_bf16(torch)
    pinned = check_pinned_capture(torch)
    del timer  # frees the 1 GiB flush buffer for the training runs
    torch.cuda.empty_cache()

    training, counts = run_training_phases(torch)
    resume, resume_counts = run_resume_phases(torch)
    serving, serve_counts, served = run_serving(torch, GPT2_SMALL, "cuda",
                                                **SERVING)
    wire, wire_counts = run_wire(torch, served, SERVING["max_new"],
                                 SERVING["pool_blocks"], SERVING["n_spec"],
                                 **WIRE)
    observ, obs_counts = run_observability(
        torch, served, serve_counts, SERVING["max_new"],
        SERVING["pool_blocks"], SERVING["n_spec"])
    plane, plane_counts = run_plane(
        torch, served, serve_counts, SERVING["max_new"],
        SERVING["pool_blocks"], SERVING["n_spec"])
    del served
    torch.cuda.empty_cache()
    predictor, pred_counts = run_predictor(torch)
    hapi, hapi_counts = run_hapi(torch)
    torch.cuda.empty_cache()
    mt, mt_counts = run_mt(torch)
    torch.cuda.empty_cache()
    rn, rn_counts = run_resnet(torch)
    torch.cuda.empty_cache()
    REPORT["hapi_fit"] = hapi["hapi_fit"]  # phase 13 (a) reads its losses
    dist, dist_counts = run_distributed(torch)
    torch.cuda.empty_cache()
    phase14, p14_counts = run_phase14(torch)
    torch.cuda.empty_cache()
    phase15, p15_counts = run_phase15(torch)
    torch.cuda.empty_cache()
    phase16, p16_counts = run_phase16(torch)
    torch.cuda.empty_cache()
    phase17, p17_counts = run_phase17(torch)
    torch.cuda.empty_cache()
    phase18, p18_counts = run_phase18(torch)
    torch.cuda.empty_cache()
    phase19, p19_counts = run_phase19(torch)
    counts.update(resume_counts, **serve_counts, **wire_counts,
                  **obs_counts, **plane_counts, **pred_counts,
                  **hapi_counts, **mt_counts, **rn_counts, **dist_counts,
                  **p14_counts, **p15_counts, **p16_counts, **p17_counts,
                  **p18_counts, **p19_counts, flash_with_lse=lse_counts)
    log(f"launches per run: {json.dumps(counts)}")
    line = kernel_line(results, counts)
    REPORT.update(card=card, kernels=results,
                  layer_norm_backward=ln_bwd, bf16=bf16,
                  pinned_capture=pinned, launches=counts,
                  total_s=time.perf_counter() - t_start, **training,
                  **resume, **serving, **wire, **observ, **plane,
                  **predictor, **hapi, **mt, **rn, **dist, **phase14,
                  **phase15, **phase16, **phase17, **phase18, **phase19)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_distributed(torch, card: str, t_start: float) -> int:
    """Phases 13 and 14 alone; the report goes to
    chiprun_out/chip_smoke_distributed.json and a summary line of each
    case before the contract line."""
    dist, counts = run_distributed(torch)
    torch.cuda.empty_cache()
    phase14, p14_counts = run_phase14(torch)
    counts.update(p14_counts)
    REPORT.update(card=card, launches=counts,
                  total_s=time.perf_counter() - t_start, **dist, **phase14)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_distributed.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1)
    print(card)
    print(json.dumps({"phases": [13, 14],
                      "nccl_world4": phase14["nccl14"].get("ran", False),
                      "total_s": REPORT["total_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_static(torch, card: str, t_start: float) -> int:
    """Phase 15 alone; the report goes to chiprun_out/chip_smoke_static.json
    and a summary line before the contract line."""
    phase15, counts = run_phase15(torch)
    REPORT.update(card=card, launches=counts,
                  total_s=time.perf_counter() - t_start, **phase15)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_static.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1)
    print(card)
    print(json.dumps({"phases": [15], "launches": {
        k: nonzero(v) for k, v in counts.items()},
        "phase15_s": phase15["phase15_s"], "total_s": REPORT["total_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_recurrent(torch, card: str, t_start: float) -> int:
    """Phase 16 alone; the report goes to
    chiprun_out/chip_smoke_recurrent.json and a summary line before the
    contract line."""
    phase16, counts = run_phase16(torch)
    for path, names in PATH_KERNELS.items():
        if path in counts:
            for name in names:
                if counts[path][name] <= 0:
                    raise AssertionError(f"kernel {name} was never launched "
                                         f"on the {path} path")
    REPORT.update(card=card, launches=counts,
                  total_s=time.perf_counter() - t_start, **phase16)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_recurrent.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1)
    a = phase16["ptb_lm_large_fit"]
    print(card)
    print(json.dumps({"phases": [16], "launches": {
        k: nonzero(v) for k, v in counts.items()},
        "ptb_step_ms": a["step_ms_median_3_to_8"],
        "ptb_tokens_per_s": a["tokens_per_s"],
        "phase16_s": phase16["phase16_s"], "total_s": REPORT["total_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_vision(torch, card: str, t_start: float) -> int:
    """Phase 17 alone; the report goes to
    chiprun_out/chip_smoke_vision.json and a summary line before the
    contract line."""
    phase17, counts = run_phase17(torch)
    for path, names in PATH_KERNELS.items():
        if path in counts:
            for name in names:
                if counts[path][name] <= 0:
                    raise AssertionError(f"kernel {name} was never launched "
                                         f"on the {path} path")
    REPORT.update(card=card, launches=counts,
                  total_s=time.perf_counter() - t_start, **phase17)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_vision.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1)
    a = phase17["mv2_fit"]
    print(card)
    print(json.dumps({"phases": [17], "launches": {
        k: nonzero(v) for k, v in counts.items()},
        "mv2_step_ms": a["step_ms_median_2_to_8"],
        "mv2_images_per_s": a["images_per_s"],
        "mv2_peak_gb": a["peak_allocated_gb"],
        "phase17_s": phase17["phase17_s"], "total_s": REPORT["total_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_zoo(torch, card: str, t_start: float) -> int:
    """Phase 18 alone; the report goes to chiprun_out/chip_smoke_zoo.json
    and a summary line before the contract line."""
    phase18, counts = run_phase18(torch)
    for path, names in PATH_KERNELS.items():
        if path in counts:
            for name in names:
                if counts[path][name] <= 0:
                    raise AssertionError(f"kernel {name} was never launched "
                                         f"on the {path} path")
    REPORT.update(card=card, launches=counts,
                  total_s=time.perf_counter() - t_start, **phase18)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_zoo.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    a = phase18["txl_fit"]
    print(card)
    print(json.dumps({"phases": [18], "launches": {
        k: nonzero(v) for k, v in counts.items()},
        "moe_nccl": phase18["moe_ep"].get("nccl", {}).get("ran", True),
        "txl_step_ms": a["step_ms_median_3_to_6"],
        "txl_tokens_per_s": a["tokens_per_s"],
        "txl_peak_gb": a["peak_allocated_gb"],
        "phase18_s": phase18["phase18_s"], "total_s": REPORT["total_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_compat(torch, card: str, t_start: float) -> int:
    """Phase 19 alone; the report goes to
    chiprun_out/chip_smoke_compat.json and a summary line before the
    contract line."""
    phase19, counts = run_phase19(torch)
    for path, names in PATH_KERNELS.items():
        if path in counts:
            for name in names:
                if counts[path][name] <= 0:
                    raise AssertionError(f"kernel {name} was never launched "
                                         f"on the {path} path")
    REPORT.update(card=card, launches=counts,
                  total_s=time.perf_counter() - t_start, **phase19)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_compat.json"),
              "w") as f:
        json.dump(REPORT, f, indent=1)
    a, c = phase19["compat_qat"], phase19["compat_int8"]
    print(card)
    print(json.dumps({"phases": [19], "launches": {
        k: nonzero(v) for k, v in counts.items()},
        "qat_step_ms": a["step_ms_median_after_capture"],
        "qat_tokens_per_s": a["tokens_per_s"],
        "qat_peak_gb": a["peak_allocated_gb"],
        "int8_forward_ms": c["int8_forward_ms"],
        "fp32_forward_ms": c["fp32_forward_ms"],
        "phase19_s": phase19["phase19_s"], "total_s": REPORT["total_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
