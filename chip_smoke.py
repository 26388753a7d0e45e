#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit::

    python3 chip_smoke.py

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
11. prints one ``{"kernels": [...]}`` line with each kernel's launches,
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
LN_EXTRA_SHAPES = ((64, 45), (64, 770), (64, 4096))
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

    res = {"ms": timer(lambda: run(entry, *inp), iters=10),
           "plain_ms": timer(lambda: run(plain, *inp), iters=10),
           "library_ms": None,
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


def kernel_line(results: dict, counts: dict) -> dict:
    """The kernels JSON line. ``launches`` is the count from the run of
    the kernel's own path; ``launches_by_path`` gives every path's."""
    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_ref = "paddle_tpu/kernels/flash_attention.py"
    xent_src = "paddle_tpu_torch/csrc/fused_softmax_xent.cu"
    xent_ref = "paddle_tpu/kernels/fused_softmax_xent.py"
    adam_src = "paddle_tpu_torch/csrc/fused_adam.cu"
    adam_ref = "paddle_tpu/kernels/fused_adam.py"
    meta = {
        "layer_norm": ("serving", "paddle_tpu_torch/csrc/layer_norm.cu",
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
        "adam_leaf": ("train_seq512_fused", adam_src, f"{adam_ref}:54"),
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
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "path": path,
                     "launches": sum(counts[path][c] for c in counters),
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


def main() -> int:
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
    counts.update(resume_counts, **serve_counts, **wire_counts,
                  **obs_counts, **plane_counts, **pred_counts,
                  **hapi_counts, flash_with_lse=lse_counts)
    log(f"launches per run: {json.dumps(counts)}")
    line = kernel_line(results, counts)
    REPORT.update(card=card, kernels=results,
                  layer_norm_backward=ln_bwd, bf16=bf16,
                  pinned_capture=pinned, launches=counts,
                  total_s=time.perf_counter() - t_start, **training,
                  **resume, **serving, **wire, **observ, **plane,
                  **predictor, **hapi)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
