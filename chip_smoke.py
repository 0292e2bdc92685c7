#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``theanompi_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases kernels     # build + kernel checks only
    python3 chip_smoke.py --layers 2           # shallower full-width models
    python3 chip_smoke.py --phases cnn         # build + the CNN phase only
    python3 chip_smoke.py --phases async       # build + the async rules
    python3 chip_smoke.py --phases async_dist  # ... across processes
    python3 chip_smoke.py --phases serving_ext # speculation, handoffs, ...
    python3 chip_smoke.py --phases serving_fleet  # router, replicas, ...
    python3 chip_smoke.py --phases serving_tp  # tp = 2 serving, card 0
    python3 chip_smoke.py --phases exchange    # zero1, int8/fp8, .shards
    python3 chip_smoke.py --phases parallel_train  # tp = 2, sp = 2 training
    python3 chip_smoke.py --phases stack_train # pp = 2, MoE at ep = 2
    python3 chip_smoke.py --phases resilience  # supervisor, drills, elastic

Phases (``--phases`` takes a comma list of kernels, serving,
serving_ext, serving_fleet, serving_tp, training, exchange,
parallel_train, stack_train, cnn, async, async_dist, resilience; the
card-and-build
phase always runs; each
phase's seconds are printed at the end):

1. card and build — the card's name and power limit from nvidia-smi;
   every kernel built from ``theanompi_tpu_torch/csrc`` (one nvcc per
   source, all at once), with the build time; ptxas's report
   (registers, spills) and the shared memory and CTAs per SM of the
   tensor-core kernels (bf16, and fp32 K1-K4);
2. kernels — each kernel against its plain PyTorch version on the
   card, at the shapes the serving and training paths give it, with
   its error, tolerance and times (kernel, plain version, and the one
   PyTorch call computing the same function, where there is one): K1,
   K2 and K3 on both routes (bf16 on the tensor cores; fp32 on the
   tensor cores in three TF32 passes, each launch's route checked, two
   launches bitwise, and fp32 K1 at a tp = 2 rank's heads bitwise those
   rows of the whole launch; bf16 K1-K3 at sm_scale -0.125 and 0), K4
   (split and merge; bf16 on the tensor cores, fp32 on the tensor cores
   in three TF32 passes, each launch's route checked) at the decode
   shape, the 16-row verify shape and past one row group (20, 32, 64
   rows), both timed at 4, 16 and 32 rows, fp32 bitwise across two
   launches, a slot alone and batched, a row in 16- and 32-row launches
   and a tp = 2 rank's heads against the 8-head launch's, the serving
   RMS norm kernel also at [32, 16384] (not a TPU kernel: every
   norm of the serving decoder, one CTA a row) at 8, 32 and 64 rows
   within one bf16 ulp or 1e-6 in fp32 (64 rows: every paged decode and
   verify step), a row bitwise the same in launches of 1, 8 and 64 rows;
   then a small fp32 model served on the
   CPU (greedy ids compared) and trained 3 BSP steps on each (losses
   compared), the fp32 routes' launches counted over both;
3. v1 serving — a Llama at Llama-3-8B width (random weights from a
   seed, bf16, ``--layers`` deep, 8 by default) under ``LlamaDecoder``
   and ``Engine``: 12 greedy requests batched, 3 of them again alone,
   ids compared; kernel K1's launches counted over the batched run, and
   the norm kernel's (2 a layer and the final norm, every prefill and
   decode call); a decode-only profile;
4. paged serving — the same model under ``PagedLlamaDecoder`` with
   chunked prefill, the same requests plus 4 sharing a system prompt:
   prefix-cache hits, batched == alone, K4's launches counted; a
   decode-only profile with K4's share of the device time;
5. serving_ext — the rest of one-engine serving.  First the small fp32
   model on the card and on the CPU from one init: speculative
   (``speculate_k`` = 4) and one-token greedy ids equal on each device
   and across them, ``verify``'s token matrix equal on both, a prompt
   prefilled ``prefill_only`` on one decoder and decoded from its KV
   handoff on another giving the unified ids, a traced engine giving
   one connected span tree per request.  Then phase 4's model (bf16,
   ``--layers`` deep, 8 by default) and 16 requests (32 tokens each,
   prefix caching off): one-token decode, then ``speculate_k`` = 4 off the same
   decoder, with decode tokens/s, the accept rate, tokens per step,
   the median verify and decode steps, K4's launches (layers x verify
   steps, all on the tensor cores at 16 rows), the norm kernel's (2 a
   layer and the final norm, every decoder call), that every request
   agrees (asserted: the norm kernel makes a row's rounding independent
   of the call's row count; on a miss the phase first prints what can
   make a verify row differ from decode: K4's row against the same row
   of a decode launch, a 32-row product's rows against an 8-row one's,
   and the two logit rows at the first divergence), the wall ratio;
   decode and verify step profiles (busy share), and a decode step's
   device time with every norm through the kernel and through the
   plain expression, in turns; prefill on a second decoder and decode
   from the handoffs (ids equal to the unified run's, bytes, export and
   import times); tokens/s with the tracer off, then on (a Chrome
   trace under ``build/``, every request one connected tree); and three
   ``submit_text`` requests through ``ByteTokenizer`` against
   ``submit(encode(text))``; then ``speculate_k`` = 8 (32 K4 rows, two
   row groups) off the same decoder: K4's launches by row count and
   the ids' agreement with one-token decode (both asserted; the
   decoder runs every decode and verify product at its one row count,
   and ``equality_causes`` is printed on a miss);
6. serving_fleet — the fleet.  First the kill-one-of-three drill on the
   small fp32 model, on the card and on the CPU (ids equal across the
   devices and to one replica's).  Then phase 4's model (bf16,
   ``--layers`` deep, 2 by default) and 16 requests at 32 tokens, one
   ``PagedLlamaDecoder`` a replica over one set of weights, each
   replica an ``InProcessReplica`` thread behind a ``Router``: one
   replica (the reference ids); a profile of three replicas decoding
   (busy share, device time by kind); the drill
   (``TM_FAULT_AT=1:2:die_replica``: every future resolves, requeues
   and a failover recorded, replica 1 unhealthy, ids equal to one
   replica's); round robin against prefix affinity with prefix caching
   on (hit rates); a prefill replica and a decode replica (ids equal,
   handoff bytes, export and import times); the autoscaler (one to two
   replicas and back, exact token accounting, replica-seconds); a
   ``ReplicaServer`` child process at full width and 2 layers,
   restored from a checkpoint this run writes, killed with SIGKILL
   mid-stream beside an in-process member (every future resolves, the
   failover is recorded).  Each arm prints the ``FleetRecorder``
   numbers (aggregate decode tokens/s, TTFT and TPOT p50/p95, requests
   per replica) and checks K4's launches (layers x decode calls) and
   the norm kernel's, summed over the replicas of this process;
6b. serving_tp — tp = 2 serving at Llama-3-8B widths, ``--layers``
   deep (2 by default), two ranks on card 0 over gloo (this process is
   rank 0 and starts ``chip_smoke.py --tp-rank 1``); 8 requests at 32
   tokens: fp32 v1, paged and a tp = 1 handoff with tp = 1's ids
   (asserted), bf16 first decode step's logits within
   ``TP_LOGITS_RTOL`` of tp = 1's (asserted), greedy and sampled
   agreement and speculative (``speculate_k`` 4) against one-token
   decode (printed), each rank's K1/K4/norm launches (asserted equal
   and non-zero), tokens/s and a decode step's wall and device time at
   tp = 1 and 2; then a 2-layer fp32 tp = 2 ``ReplicaServer`` pair
   over TCP with tp = 1's ids;
7. training — ``BSP().init`` on the card with the port's Llama at
   Llama-3-8B widths, ``--layers`` deep (8 by default), seq 2048,
   batch 2, bf16, Adam, remat, the chunked head, ``ici32``: one epoch
   of 8 steps and 2 val batches, with each step's loss, the step time,
   tokens/s, peak memory and K1/K2/K3 launches (checked against
   2L/L/L per step, every launch on the tensor-core route), the losses
   held to ``TRAIN_TRAJECTORY``; the run takes ``step_profile`` and
   ``trace`` (``trace_export`` under ``build/``): after the 8 steps
   the worker profiles one step (``obs.step_profile``; the warm step,
   the FLOP count's forward and backward and the profiled step add 3
   steps' launches), and the script asserts the legs (``compute``, an
   ``exchange_b{i}``, ``optimizer``, ``host_gap``), coverage in
   [0.95, 1.05], the MFU equal to ``step_flops / (step_s * peak)`` with
   the H100's peak and in (0, 1], ``trace_spans`` = the iterations'
   spans, the export's iteration spans and counter tracks and the
   ``tm_train_*`` families of ``metrics_txt``; then a 2-step profile,
   whose device time a step the profile's busy time must be within
   ``PROFILE_BUSY_RTOL`` of, and one more staged step's copies and host
   syncs (``host_traffic``: host-to-device copies counted at dispatch,
   asserted equal to the stager's bytes, and the CUDA runtime's memcpy
   and synchronizing calls); then the same cell twice more
   (``run_training_arms``): the train set on the card with
   ``steps_per_call`` = ``TRAIN_CHUNK`` (8 steps, two ``train_chunk``
   calls; losses asserted bitwise the staged run's, K1/K2/K3 2L/L/L a
   step, no byte to the card and no host sync in one more chunk) and
   ``remat_save=("attn_out",)`` (losses asserted bitwise full remat's,
   K1 asserted L a step, not 2L); each arm's step, tokens/s and peak
   memory beside the staged run's;
7b. exchange — the exchange extensions.  The training phase's run
   again through ``BSP().init`` with ``exch_strategy="zero1"`` (losses
   asserted bitwise the ``ici32`` run's, or held to
   ``TRAIN_TRAJECTORY`` when the training phase did not run) and with
   zero1 on the int8 wire with error feedback (losses within
   ``EXCH_INT8_RTOL`` of ``ici32``'s), each with its step time,
   tokens/s, peak memory, K1/K2/K3 launches (2L/L/L a step, tensor
   cores) and a 2-step profile's elementwise/memcpy/GEMM split beside
   ``ici32``'s; the int8 arm also takes ``step_profile``: a ``quantize``
   leg above 0 and one ``exchange_b{i}`` leg a bucket of the flat spec,
   asserted; then two ranks on card 0 over gloo (two children,
   ``chip_smoke.py --exchange-rank r``), full width, ``EXCH_LAYERS``
   deep: zero1 on the fp8 wire (no residual) for ``EXCH_STEPS`` steps,
   saved as a
   ``.shards`` checkpoint (verified), resumed at one rank with
   ``load(reshard=True)`` (parameters and gathered m/v bitwise the two
   ranks', by their crc32s against the digests the ranks stamped), and
   served from the ``.shards`` directory by ``decoder_from_checkpoint``
   (``EXCH_REQUESTS`` greedy requests, the ids of a decoder over the
   same parameters in memory; K4's launches); then one ResNet-50
   exchange alone over the TCP center on the fp32, int8 and fp8 wires
   (bytes each way, the D2H / exchange / H2D split) and the codec's
   identity (the center decodes what the sender decodes); then the
   layout arm (``exchange_layout_arm``), four ranks on card 0 over gloo
   through the parallel_train phase's children: tp = 2 x data = 2 at
   Llama-3-8B widths (``PT_LAYERS`` deep, seq ``PT_SEQ``, bf16, Adam)
   under ``ici32`` and zero1 for ``XL_STEPS`` steps (losses asserted
   bitwise, K1/K2/K3 2L/L/L a step on the tensor cores, each rank's
   peak GiB, step ms and reduce-scatter, all-gather and all-reduce
   ms); the small fp32 model under zero1 against ``ici32`` at tp = 2,
   pp = 2 and sp = 2 (ring), each x data = 2 (``XL_RTOL``), the int8
   wire with error feedback at tp = 2 x data = 2 (``EXCH_INT8_RTOL``),
   a zero1 + int8 ``.shards`` checkpoint resumed bitwise an
   uninterrupted run, an ``ici32`` checkpoint resumed elastically at
   tp = 2 x data = 1 on two ranks against the same resume on the CPU
   (``TRAIN_REF_RTOL``), and the zero1 + int8 checkpoint resumed at
   tp = 1 x data = 2, refused with the JAX reshard's words;
7c. parallel_train — Llama training at tp > 1 and sp > 1 through
   ``bsp_worker.run``, ranks on card 0 over gloo: the one-rank run in
   this process (a one-rank NCCL group), then two children
   (``chip_smoke.py --pt-rank r``) that run in turn tp = 2, sp = 2 with
   ring attention and sp = 2 with Ulysses, then four that run tp = 2 x
   sp = 2 (ring); each layout first at the small width in fp32 (SGD at
   lr 0.5; K1, K2 and K3 in three TF32 passes),
   then at Llama-3-8B widths,
   ``PT_LAYERS`` deep, seq 8192, batch 1, bf16, Adam, remat, the
   chunked head (the tensor cores), ``PT_STEPS`` steps from the same
   seed's init (drawn whole, then sharded) and batches.  Every rank's
   losses are held to the one-rank run's within ``PT_RTOL`` and the
   norm of each leaf's first exchanged gradient (its shards' over the
   model group) to the one-rank run's within ``PT_GRAD_RTOL`` (Adam
   hides a gradient's scale from the losses), its K1/K2/K3 launches
   to the formula (seq rank r folds r + 1 ring hops a layer, the
   forward twice under remat) on its dtype's route, and no plain
   version of K1-K3 and no SDPA may run on the path; each rank's step
   time, tokens/s, peak memory and the wall time of its collectives
   (the ring's hop, the Ulysses all-to-all, the tp all-reduces, the
   gradient exchange: at sp = 2 the seq group's f32 gradient mean) are
   printed.  Then K1, K2 and K3 against their plain versions at every
   shape and causality the path gives them (``pt_path_shapes``), and
   K2/K3 against the global (lse, delta) of a two-block merge, as the
   ring's backward feeds them; K1, K2 and K3 timed at the ring's full
   (non-causal) hop shape [1, 32, 4096, 128] bf16 beside their bounds
   and SDPA;
7d. stack_train — Llama training at pp > 1 and with MoE experts at
   ep >= 1, the ranks on card 0 over gloo, through the parallel_train
   phase's children: the one-rank runs in this process, then two
   children that run in turn MoE at ep = 1 over two data replicas,
   ep = 2, pp = 2 (MoE) and pp = 2 dense, then four that run pp = 2 x
   ep = 2; each at the small width in fp32
   (4 experts, top-2, capacity factor 2.0; SGD at lr 0.5; the fp32
   kernels), then ep = 2 and pp = 2 at Mixtral-8x7B's published widths
   (``MIXTRAL_8X7B``), ``ST_LAYERS`` deep, seq ``ST_SEQ``, global batch
   2, bf16, Adam, remat, capacity factor 4.0 = E/k (nothing drops, as
   Mixtral routes), ``ST_STEPS`` steps (the tensor cores).  Each rank's
   losses against the one-rank run's (``PT_RTOL``; a bf16 MoE arm's
   after the first step within ``ST_MOE_RTOL``: routing is discrete, so
   bf16 rounding moves a few tokens' picks), each leaf's first
   exchanged gradient norm (router and expert leaves included; a
   stage's layers by their global index, an expert leaf's shards over
   the expert group) against the one-rank run's (``PT_GRAD_RTOL``),
   K1/K2/K3 launches by formula (a stage runs its L/pp layers on each of
   the M + pp - 1 ticks, the forward twice under remat), no plain
   version and no SDPA; the step's ms and tokens/s, the token
   all-to-alls', chain hops', pipe broadcasts', pipe sum's and
   exchange's ms, the peak GiB a rank and each layer's expert load f
   printed.  Then K1, K2 and K3 against their plain versions at the
   path's shapes (``st_path_shapes``);
8. cnn — the image-classifier path on synthetic ImageNet/CIFAR data
   (``TM_DATA_DIR`` points at an empty directory under ``build/``): a
   small fp32 WResNet trained 3 BSP steps on the card and on the CPU
   (losses compared), and the val step of small fp32 AlexNet, VGG16
   and GoogLeNet (with its train-mode loss and aux terms) on both; then
   ``BSP().init`` on the card with ResNet-50 at its published config
   (crop 224, 1000 classes, batch 128, bf16 compute, fp32 master
   weights, momentum 0.9, weight decay 1e-4, lr 0.1, ``ici32``) under
   each of the four feeds (the pinned stager inside the step,
   ``loader_pipeline=2``, ``device_data_cache=True``, and the same with
   ``steps_per_call=4``: two ``train_chunk`` calls, its losses asserted
   bitwise the per-step cache's, no byte to the card and no host sync
   in one more chunk): 8 steps, each
   timed with its Recorder wait and calc segments, and 2 val batches,
   with the median step, images/s, peak memory, the feed's counts and
   a 2-step profile (busy share, memcpy time); the losses held to
   ``CNN_TRAJECTORY``, the batches the net took bitwise equal across
   the feeds (a checksum of each on the card); AlexNet at its
   published config the same way; VGG16 and GoogLeNet at their JAX
   defaults (crop 224, batch 32, bf16, lr 0.01) the same way, each with
   a profile, their losses held to ``VGG16_TRAJECTORY`` and
   ``GOOGLENET_TRAJECTORY``; ResNet-50 again from 8 x 128 ``.tmb``
   files the run writes, through the C++ loader and through the
   prefetch thread (``feed`` asserted, batches bitwise equal), each
   beside the device-resident feed; then the ``torch.nn`` zoo
   (``models/torch_zoo``, flax_zoo's counterpart): ``TorchResNet18`` at
   width 64 on synthetic CIFAR-10, batch 128, at the JAX defaults'
   precision, 8 steps from a seeded init (its first loss within
   ``CNN_REF_RTOL`` of the CPU's, the median step and images/s), and
   ``TorchCNN`` under EASGD with two replicas on the card for one
   epoch (exchanges made; its val numbers on one set of parameters
   held to the CPU's first).  No TPU kernel lies on this path:
   convolutions and matmuls are cuDNN's and cuBLAS's, BN, pooling and
   LRN plain PyTorch, the staging copies;
9. async — the asynchronous rules in one process, ``ASYNC_W`` = 4
   replicas stacked on the card, on synthetic data: first a tiny fp32
   LSTM under GoSGD (W = 2, staleness 1) and WResNet-10-1 under EASGD
   (W = 2, ``speeds`` set) trained on the card and on the CPU from one
   init checkpoint (losses, val loss and scores compared); then
   BASELINE.json config 4, ``GOSGD().init`` with the IMDB LSTM at the
   JAX defaults (vocab 10000, embedding and hidden 128, maxlen 100,
   batch 32 a worker, dropout 0.5, bf16, push probability 0.25), and
   config 3, ``EASGD().init`` with ResNet-50 at the cnn phase's
   published config (alpha 1/4, tau 4): 8 steps each, every iteration
   timed with its Recorder wait, calc and comm segments, and 2 val
   batches, with the median step, reviews or images a second, the
   gossip rounds or center merges, peak memory and a 2-step profile of
   the replica steps (busy share); the losses held to
   ``LSTM_GOSGD_TRAJECTORY`` and ``RESNET50_EASGD_TRAJECTORY``.  The
   kernels' launch counts over the phase are printed: no kernel of the
   package lies on this path;
10. async_dist — the asynchronous rules across processes, each process
   one worker on the card: first EASGD's ``_run_distributed`` in one
   process (a world of one, the center on 127.0.0.1, alpha 0.5, tau 2)
   on a tiny fp32 LSTM, on the card and on the CPU from one init
   checkpoint (losses and the center's val loss compared); then
   ``DIST_W`` = 4 processes started through the port's CLI
   (``--coordinator 127.0.0.1:<port> --num-hosts 4 --host-id i
   --devices 0``), all on card 0: config 3, EASGD x ResNet-50 at the
   async phase's configuration (batch 128 a process, bf16, alpha 1/4,
   tau 4, over the TCP center server on process 0), and config 4, GoSGD
   x the IMDB LSTM at the JAX defaults (push probability 0.25, over the
   gossip peers, a checkpoint directory so the best-score election
   runs); 8 steps and 2 val batches a process, every iteration fenced.
   Per process: the median iteration, images or reviews a second, comm
   time, exchanges with their bytes or pushes, deliveries, merges and
   score, peak memory; process 0's center statistics and center val
   loss; the aggregate rate.  It fails unless every process exits 0,
   GoSGD's scores sum to 1 within 1e-5, its merges equal its
   deliveries, and exactly the best-scoring process saved.  These runs
   measure the TCP exchange and the host on one card, not scaling
   across cards;
11. resilience — the supervisor, the drills, checkpoint validation and
   the elastic resume, on the port's BSP worker; the children's K1-K3
   launches, steps and checkpoint seconds come from the journals their
   processes keep (``install_journal``: the supervised runs start this
   script as their worker, which runs the port's
   ``bsp_worker.worker_main`` inside the journal).  First the drill
   matrix: the small fp32 model (the fp32 K1-K3) in one
   ``BSP().init(launch="supervised")`` from an
   init checkpoint, ``TM_FAULT_AT`` = ``RES_DRILLS`` (die, hang,
   sigterm, corrupt_ckpt, each after a committed checkpoint; an 8 s
   watchdog for the hang): each restart's cause, exit code and
   ``resumed_from`` asserted, ``ckpt_3.npz`` quarantined as
   ``*.corrupt``, the 15 losses bitwise an unsupervised run's from the
   same init, each restart's time to recovery and the MTTR printed.
   Then graceful preemption at Llama-3-8B widths (bf16, ``RES_LAYERS``
   deep, Adam, K1-K3 on the tensor cores): one supervised launch, a sigterm
   after step 2, the preemption checkpoint stamped ``next_iter`` 3 and
   the relaunch resumed there: 3 steps a life (none lost or repeated),
   losses bitwise an uninterrupted run's, K1/K2/K3 launches 13/6/6;
   the checkpoint's GiB, the preemption save, the resume (validation and
   load) and the epoch's save seconds, the time to recovery.  Then the
   elastic shrink: two ranks on card 0 over gloo (``--resilience-rank
   r`` children under an elastic ``Supervisor``), the small model under
   bucketed zero1, ``shrink_world`` in epoch 1: world sizes [2, 1], the
   ``"global"`` policy's batch 4, the zero1 state resharded, the losses
   within ``RES_ELASTIC_RTOL`` of a one-rank resume of the same
   checkpoint, and the preemption agreement's one-element allreduce
   timed at each world.  The full-width run's card sits idle through
   most of its checkpoint I/O, so the drill matrix and the elastic
   shrink run while it goes on: the three arms' seconds are taken side
   by side (``REDUCED``);
12. the kernels line — one JSON object with every kernel's numbers.

The last line of standard output is ``{"ok": true, "device": ...}``.
Any failure raises and the exit code is not 0.  Without a CUDA device,
or without the package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): bytes/s, and ops/s by the
# route's arithmetic: bf16 and fp32 (CUDA cores: the fp32 RMS norm) at
# their peaks; fp32 K1-K4 three TF32 passes on the tensor cores (495
# TF/s), so a third of the TF32 rate in fp32 operations
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
# (atol, rtol) of a kernel against its plain version evaluated in fp32
# on the same inputs: fp32 differs by summation order only; bf16 adds
# the rounding of the output to bf16 (half an ulp: 2**-9 relative)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}

REDUCED = {
    "max_seq": "2048 (LLAMA3_8B.seq_len 8192): the run's time limit",
    "n_layers (serving, v1 and paged)": "8 (32): the run's time limit",
    "n_layers (serving_fleet)": "2 (32): the run's time limit (8 until "
    "the exchange phase took its time, 4 until the stack_train phase "
    "did); its asserts (the drill's and the "
    "policies' ids equal to one replica's, K4 and norm launches a layer) "
    "do not need depth; serving_ext keeps 8 layers, where "
    "speculative ids are held to one-token ids",
    "n_layers (serving_ext)": "8 (32): the run's time limit (32 until "
    "the resilience full-width arm went back to Adam, 16 until the "
    "exchange phase's layout arm and the cnn phase's torch.nn zoo took "
    "their time); every layer runs "
    "the same K4, norm and GEMM calls, so the speculative = one-token "
    "ids, the launch counts and the rows' equality are asserted as at "
    "32; the widths are Llama-3-8B's",
    "tracing (serving_ext)": "tokens/s traced and not, once each (off, "
    "on, on, off until the exchange phase took its time): the ids and "
    "the span trees are asserted on the traced run",
    "steps (exchange, two ranks)": "2 (4): the run's time limit; the "
    "save, the reshard and the served ids are asserted after them",
    "n_layers (training)": "8 (32): fp32 master weights, gradients and "
    "Adam moments of 8.03 B parameters come to 128.5 GB, over the "
    "card's 80 GB",
    "seq_len (training)": "2048 (8192): the run's time limit",
    "dataset (cnn)": "synthetic, 8 x 128 train and 2 x 128 val images "
    "for ResNet-50 and AlexNet (ImageNet: 1.28 M / 50 k): no ImageNet "
    "files in the repository; a cut of the dataset's size, not a width",
    "dataset (cnn, VGG16 and GoogLeNet)": "synthetic, 8 x 32 train and "
    "2 x 32 val images (ImageNet: 1.28 M / 50 k): as above",
    "dataset (async, LSTM)": "the synthetic IMDB task, 8 x 128 train and "
    "2 x 128 val reviews (IMDB: 25 k / 25 k): no imdb.pkl in the "
    "repository; a cut of the dataset's size, not a width",
    "dataset (async, ResNet-50)": "synthetic, 8 x 512 train and 2 x 512 "
    "val images (ImageNet: 1.28 M / 50 k): as above",
    "workers (async)": "4 replicas stacked on one card (the reference "
    "ran one worker process per GPU, the JAX package one replica per "
    "mesh device): the run has one card",
    "workers (async_dist)": "4 worker processes sharing one card (the "
    "reference ran one per GPU): the run has one card",
    "dataset (async_dist)": "synthetic, 8 steps and 2 val batches a "
    "process (IMDB 25 k / 25 k, ImageNet 1.28 M / 50 k): as above",
    "n_layers (serving_fleet, TCP replica)": "2 (32): the child process "
    "restores the model from an fp32 checkpoint this run writes (6.0 GB "
    "at 2 layers, 32.1 GB at 32); the width is Llama-3-8B's",
    "replicas (serving_fleet)": "up to 3 in-process replicas sharing one "
    "card and one model's weights (a deployment gives each its own "
    "card): the run has one card",
    "n_layers (serving_tp)": "2 (32): the run's time limit (8 until the "
    "exchange phase took its time, 4 until the stack_train phase did; "
    "its fp32 ids and launch counts do not need depth); the widths are "
    "Llama-3-8B's",
    "ranks (serving_tp)": "tp = 2 as two processes on card 0 over gloo, "
    "which stages every collective through the host (a deployment gives "
    "each rank a card and uses NCCL, which refuses two ranks on one "
    "card): the run has one card",
    "n_layers (serving_tp, TCP replica)": "2 (32), as the serving_fleet "
    "TCP child: its fp32 checkpoint is written and read in the run",
    "n_layers (exchange, two ranks)": "2 (32): two full-width ranks of "
    "8 layers (fp32 masters, gradients, Adam shards and the EF residual "
    "each) do not fit one card beside each other; the widths are "
    "Llama-3-8B's",
    "error_feedback (exchange, two ranks)": "off: the fp8 arm's r1 "
    "residual (a full fp32 buffer a rank, 11.9 GB of the 27.7 GB "
    "checkpoint) would add a minute of saving, hashing and resharding "
    "to the run's clock; the int8 arm at one rank keeps it on, and the "
    "residual's reshard is held on two CPU ranks "
    "(tests/test_torch_reshard.py)",
    "ranks (exchange)": "zero1 over two processes on card 0 over gloo, "
    "which stages every collective through the host (a deployment gives "
    "each rank a card and NCCL, which refuses two ranks on one card): "
    "the run has one card",
    "n_layers (resilience, full width)": "1 (32): one supervised run "
    "writes, validates and reads back an fp32 checkpoint at 1 layer (with "
    "Adam's moments 15.2 GB at 1 layer, 17.8 GB at 2 until the "
    "parallel_train phase took its time, 96.4 GB at 32); the widths are "
    "Llama-3-8B's",
    "steps (resilience, full width)": "6, one epoch (the sigterm drill after "
    "step 2, resumed at step 3): the run's time limit",
    "timing (resilience)": "the drill matrix and the elastic shrink run "
    "while the full-width supervised run writes, validates and reads its "
    "checkpoint (one after the other until the exchange phase's layout "
    "arm and the cnn phase's torch.nn zoo took their time): every "
    "assertion is kept, but the arms' recovery, save and resume seconds "
    "are taken sharing the host's disk and cores",
    "n_layers (parallel_train)": "2 (32): two ranks at sp = 2 "
    "hold the whole fp32 model and its Adam state each (23.8 GB at 2 "
    "layers, 352 GB at 32), two or four of them on one card; the widths "
    "and seq_len 8192 are Llama-3-8B's",
    "ranks (parallel_train)": "tp = 2, sp = 2 and tp = 2 x sp = 2 as two "
    "and four processes on card 0 over gloo, which stages every collective "
    "through the host (a deployment gives each rank a card and NCCL, which "
    "refuses two ranks on one card): the run has one card",
    "steps (parallel_train)": "2 a layout (3 until the stack_train "
    "phase took its time), batch 1, no val pass: the run's time limit "
    "(the seq group's gradient mean moves the fp32 gradients through "
    "gloo every step)",
    "ranks (resilience, elastic)": "two processes on card 0 over gloo, "
    "shrunk to one (a deployment gives each rank a card and NCCL, which "
    "refuses two ranks on one card): the run has one card",
    "n_layers (stack_train)": "2 (Mixtral-8x7B: 32): one rank holds "
    "the fp32 masters, gradients and Adam moments of 3.16 B parameters "
    "(50.6 GB) at 2 layers, and ep = 2 and pp = 2 put two ranks of "
    "27-28 GB each on the one card; the widths (dim 4096, 32 heads, 8 kv "
    "heads, ffn 14336, vocab 32000, 8 experts, top-2) are Mixtral's",
    "seq_len (stack_train)": "4096 (Mixtral-8x7B: 32768): the card's "
    "memory beside two ranks' state, and the run's time limit",
    "rope_theta (stack_train)": "10000, the port's (Mixtral: 1e6): not a "
    "width; the port has no theta knob",
    "steps (stack_train)": "3 an arm, global batch 2, no val pass: the "
    "run's time limit",
    "ranks (stack_train)": "ep = 2, pp = 2 and pp = 2 x ep = 2 as two "
    "and four processes on card 0 over gloo, which stages every "
    "collective through the host (a deployment gives each rank a card "
    "and NCCL): the run has one card",
    "steps (exchange, layout arm, full width)": "2 an exchange, batch 1 "
    "a replica, no val pass: the run's time limit (the data pair's f32 "
    "gradient exchange moves 3 GB a rank through gloo every step)",
    "n_layers (exchange, layout arm)": "2 (32), parallel_train's: four "
    "ranks of tp = 2 hold 0.74 B parameters each with their fp32 "
    "gradients and Adam moments on one card; the widths and seq_len "
    "8192 are Llama-3-8B's",
    "ranks (exchange, layout arm)": "tp = 2 x data = 2 (and pp = 2, sp = "
    "2 x data = 2 small) as four processes on card 0 over gloo, the "
    "elastic resume as two (a deployment gives each rank a card and "
    "NCCL): the run has one card",
    "dataset (cnn, torch_zoo)": "synthetic CIFAR-10, 8 x 128 train and "
    "2 x 128 val images for ResNet-18, 8 x 256 and 1 x 256 for the "
    "EASGD CNN (CIFAR-10: 50 k / 10 k): no CIFAR files in the "
    "repository; a cut of the dataset's size, not a width",
    "dataset (cnn, native feed)": "8 x 128 train and 2 x 128 val "
    "synthetic 256 x 256 uint8 images written as .tmb files (ImageNet: "
    "1.28 M / 50 k): a cut of the dataset's size, not a width",
}
# per-step losses of the small fp32 model trained on the card and on
# the CPU from one initial state: fp32 summation order differs between
# the devices and Adam carries it on (measured ~1e-6 relative)
TRAIN_REF_RTOL = 1e-4
# first and last training loss and the val loss of phase 5 at its
# default depth (8 layers), as kernels with fp32 products gave them on
# an H100: the bf16 tensor-core kernels, which round P and dS to
# bf16 before their products, must stay within TRAIN_TRAJECTORY_RTOL
TRAIN_TRAJECTORY = {"first": 11.7917, "last": 11.7502, "val": 11.7429}
TRAIN_TRAJECTORY_RTOL = 1e-3
# the training profile's extra steps on the counted path: the worker's
# warm step, train_step_flops's forward and backward, the profiled step
PROFILE_STEPS = 3
# the step profile's device busy time a step against profile_training's
# device time a step (an independent reading of the same model)
PROFILE_BUSY_RTOL = 0.10
# the step profile's coverage (the legs' sum over the step), the JAX
# package's own bar
PROFILE_COVERAGE = (0.95, 1.05)
# decode tokens/s with the serving ranges' profiler check against none
# at all: the ranges must cost nothing while nobody profiles
RANGE_COST_RTOL = 0.05
# the CNN phase's card-vs-CPU checks: fp32, per-step losses and the
# AlexNet val numbers differ by summation order only (cuDNN against the
# CPU's convolutions), amplified over 3 momentum steps
CNN_REF_RTOL = 1e-4
# first and last ResNet-50 training loss and its val loss in the cnn
# phase (seed 0, synthetic data), as the first run of this phase gave
# them on an H100: later runs must stay within CNN_TRAJECTORY_RTOL (bf16
# products over 8 steps at lr 0.1, with cuDNN free to pick other
# algorithms, or split-K weight gradients, from run to run)
CNN_TRAJECTORY = {"first": 6.92595, "last": 7.25439, "val": 7.42520}
CNN_TRAJECTORY_RTOL = 1e-2
# the same for VGG16 and GoogLeNet at their JAX defaults (batch 32,
# lr 0.01, seed 0, synthetic data), as the first run of the cnn phase
# with them gave them on an H100; held at CNN_TRAJECTORY_RTOL
VGG16_TRAJECTORY = {"first": 7.15341, "last": 6.91443, "val": 6.95076}
GOOGLENET_TRAJECTORY = {"first": 11.3753, "last": 11.0767, "val": 6.90323}
# depth of the serving phases (v1 and paged; serving_fleet) unless
# --layers says
SERVING_LAYERS = 8
FLEET_LAYERS = 2
# depth of serving_ext unless --layers says (REDUCED), where its
# speculative = one-token equality is asserted
EXT_LAYERS = 8
PHASES = ("kernels", "serving", "serving_ext", "serving_fleet",
          "serving_tp", "training", "exchange", "parallel_train",
          "stack_train", "cnn", "async", "async_dist", "resilience")


def log(*a):
    print(*a, flush=True)


@functools.cache
def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them,
    read once a run: neither changes while it runs."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(got, ref, dtype_name: str) -> tuple[float, bool]:
    """(max |got - ref|, whether every element is within
    atol + rtol * |ref|) under ``TOL[dtype_name]``."""
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return diff.max().item(), ok


def time_ms(fn, *, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` launches,
    each timed alone with CUDA events after ``warmup`` calls; ``flush``
    (a large tensor) is overwritten before every launch so each one
    finds the L2 cache cold, as a layer's call on the serving path
    does, and so the device is still busy with it while the host
    enqueues ``fn``'s kernels: the window holds device time only."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions -------------------------

#: operations per live (q, k) pair and unit of head dim: K1 does 2
#: products (S, O), K2 4 (S, dP, dV, dK), K3 3 (S, dP, dQ)
FLASH_OPS_PER_PAIR = {"fwd": 4, "dkv": 8, "dq": 6}


def flash_ops(kernel: str, shape, causal: bool = True) -> float:
    """Operations of one K1 (``"fwd"``), K2 (``"dkv"``) or K3 (``"dq"``)
    launch on q of ``shape`` [B, H, T, D] against keys of the same
    length: causal, query i sees keys 0..i."""
    b, h, t, d = shape
    pairs = b * h * (t * (t + 1) / 2 if causal else t * t)
    return FLASH_OPS_PER_PAIR[kernel] * d * pairs


def bound(ops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): ``ops`` at the
    peak rate of ``dtype_name`` (a ``PEAK_OPS`` key) against ``nbytes``
    at the HBM rate."""
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def route(dtype_name: str) -> str:
    """Which kernel of K1, K2 or K3 a dtype takes on the card."""
    if dtype_name == "bfloat16":
        return "tensor cores"
    return "tensor cores, three TF32 passes"


def route_counts(fn) -> list:
    """A K1-K4 wrapper's [launches, bf16 tensor-core launches, three-pass
    TF32 launches]."""
    return [fn.launches, fn.tc_launches, fn.tf32x3_launches]


def routes_want(dtype_name: str, launches: dict) -> dict:
    """The ``route_counts`` K1-K4 (keys "K1" to "K4") must show after
    ``launches`` of each in ``dtype_name``: bf16 all on the bf16 tensor
    cores, fp32 all in three TF32 passes."""
    if dtype_name == "bfloat16":
        return {k: [n, n, 0] for k, n in launches.items()}
    return {k: [n, 0, n] for k, n in launches.items()}


def check_flash(dev, flush) -> dict:
    """K1 against ``mha_reference_fwd`` evaluated in fp32 on both routes
    (bf16: the bf16 tensor-core kernel, fp32: three TF32 passes) at the
    serving shapes, each launch checked to take its dtype's route, the
    fp32 route at T = 2047 twice and bitwise; times at T = 2047 for
    both, and at the training shape [2, 32, 2048, 128] bf16; both dtypes
    also at a tp = 2 rank's 16 heads (``tp_rank_shape``: the second half
    of the 32-head inputs' heads, fp32 bitwise those rows of the 32-head
    launch).  Returns the records of the two routes, keyed "K1" (bf16)
    and "K1 fp32"."""
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops.attention import (
        flash_fwd_cuda,
        mha_reference,
        mha_reference_fwd,
    )

    def run(q, k, v, name):
        before = route_counts(flash_fwd_cuda)
        out = flash_fwd_cuda(q, k, v, True, q.shape[-1] ** -0.5)
        took = [a - b for a, b in zip(route_counts(flash_fwd_cuda), before)]
        if took != routes_want(name, {"K1": 1})["K1"]:
            raise AssertionError(f"K1 {name}: launch took the wrong route")
        return out

    gen = torch.Generator(device=dev).manual_seed(1)
    h, hd = 32, 128
    records, full = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for t in (16, 512, 2047):
            q, k, v = (
                torch.randn((1, h, t, hd), generator=gen, device=dev)
                .to(dtype) for _ in range(3)
            )
            o, lse = run(q, k, v, name)
            full[name, t] = (q, k, v, o, lse)
            o_ref, lse_ref = mha_reference_fwd(
                q.float(), k.float(), v.float(), causal=True
            )
            torch.cuda.synchronize()
            err, ok_o = compare(o, o_ref, name)
            lerr, ok_l = compare(lse, lse_ref, "float32")
            ok = ok_o and ok_l
            log(f"K1 flash_fwd {name} ({route(name)}) [1,{h},{t},{hd}] "
                f"causal: max_abs_err o {err:.3e} (atol, rtol "
                f"{TOL[name]}), lse {lerr:.3e} (atol, rtol "
                f"{TOL['float32']}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with mha_reference "
                                     f"at {name} T={t}")
            if t != 2047:
                continue
            tc = name == "bfloat16"
            if not tc:
                # one owner per output row, no atomics: a second launch
                # is bitwise the first
                same = all(torch.equal(a, b) for a, b in
                           zip((o, lse), run(q, k, v, name)))
                log(f"K1 flash_fwd {name} [1,{h},{t},{hd}]: two launches "
                    f"{'bitwise' if same else 'DIFFER'}")
                if not same:
                    raise AssertionError(f"K1 {name}: two launches differ")
            ms = time_ms(lambda: run(q, k, v, name), flush=flush)
            plain = time_ms(lambda: mha_reference(q, k, v, causal=True),
                            flush=flush)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), flush=flush)
            b_ms, b_by = bound(
                flash_ops("fwd", q.shape),
                4 * q.numel() * q.element_size() + lse.numel() * 4,
                name if tc else "tf32x3")
            records["K1" if tc else "K1 fp32"] = {
                "name": "flash_fwd_tc" if tc else "flash_fwd_tf32x3",
                "route": "cuda",
                "source": "theanompi_tpu_torch/csrc/flash_fwd.cu",
                "replaces": "theanompi_tpu/ops/attention.py:146",
                "shape": f"[1,{h},{t},{hd}] {name} causal",
                "launches": None, "max_abs_err": max(err, lerr), "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib,
            }
            log(f"K1 times {name} ({route(name)}) T={t}: kernel {ms:.4f} "
                f"ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
    # serving_tp's v1 prefill at tp = 2: rank 1's 16 q heads of the
    # 32-head inputs
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        rank = records["K1" if name == "bfloat16" else "K1 fp32"][
            "tp_rank_shape"] = {}
        for t in (16, 512, 2047):
            q, k, v, o32, lse32 = full[name, t]
            q, k, v = (x[:, h // 2:].contiguous() for x in (q, k, v))
            o, lse = run(q, k, v, name)
            o_ref, lse_ref = mha_reference_fwd(
                q.float(), k.float(), v.float(), causal=True)
            err, ok_o = compare(o, o_ref, name)
            lerr, ok_l = compare(lse, lse_ref, "float32")
            # fp32: bitwise the 32-head launch's rows of these heads
            same = name == "bfloat16" or (
                torch.equal(o, o32[:, h // 2:])
                and torch.equal(lse, lse32[:, h // 2:]))
            ok = ok_o and ok_l and same
            rank[f"[1,{h // 2},{t},{hd}]"] = max(err, lerr)
            log(f"K1 flash_fwd {name} ({route(name)}) [1,{h // 2},{t},{hd}] "
                f"causal (a tp = 2 rank): max_abs_err o {err:.3e}, lse "
                f"{lerr:.3e}"
                + ("" if name == "bfloat16" else
                   f", {'bitwise' if same else 'NOT bitwise'} the 32-head "
                   f"launch's rows")
                + f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with mha_reference or "
                                     f"the 32-head launch at {name} "
                                     f"[1,{h // 2},{t},{hd}]")
    del full
    # the training path's shape: two sequences of 2048, bf16, causal
    q, k, v = (torch.randn((2, h, 2048, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    o, lse = run(q, k, v, "bfloat16")
    o_ref, lse_ref = mha_reference_fwd(q.float(), k.float(), v.float(),
                                       causal=True)
    err, ok_o = compare(o, o_ref, "bfloat16")
    lerr, ok_l = compare(lse, lse_ref, "float32")
    ms = time_ms(lambda: run(q, k, v, "bfloat16"), flush=flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), flush=flush)
    b_ms, _ = bound(flash_ops("fwd", q.shape),
                    4 * q.numel() * q.element_size() + lse.numel() * 4,
                    "bfloat16")
    log(f"K1 flash_fwd bfloat16 (tensor cores) [2,{h},2048,{hd}] causal "
        f"(training): max_abs_err o {err:.3e}, lse {lerr:.3e}, kernel "
        f"{ms:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"(operations) -> {'ok' if ok_o and ok_l else 'FAIL'}")
    if not (ok_o and ok_l):
        raise AssertionError("K1 disagrees with mha_reference at the "
                             "training shape")
    records["K1"]["training_shape"] = {
        "shape": f"[2,{h},2048,{hd}] bfloat16 causal",
        "max_abs_err": max(err, lerr), "ms": ms, "library_ms": lib,
        "bound_ms": b_ms}
    return records


def bwd_bound(name, q, dtype_name, causal=True):
    """(bound ms, what bounds it) of K2 or K3 on q-shaped inputs: their
    ``flash_ops`` (fp32: three TF32 passes on the tensor cores) against
    q, k, v, dO, lse, delta read once and the outputs written once."""
    b, h, t, _ = q.shape
    ops = flash_ops(name, q.shape, causal)
    n_out = 2 if name == "dkv" else 1
    nbytes = (4 + n_out) * q.numel() * q.element_size() + 2 * b * h * t * 4
    return bound(ops, nbytes,
                 "tf32x3" if dtype_name == "float32" else dtype_name)


def check_flash_bwd(dev, flush) -> dict:
    """K2 (dK, dV) and K3 (dQ), both routes, against
    ``flash_bwd_reference`` evaluated in fp32 on the same inputs and
    residuals, each launch checked to take its dtype's route (bf16: the
    tensor-core kernel, fp32: three TF32 passes), the fp32 route twice
    and bitwise; times of the fp32 routes at [1, 32, 2047, 128] and of
    the bf16 kernels at the training shape [2, 32, 2048, 128].  Returns
    the records keyed "K2" (bf16), "K2 fp32", "K3" (bf16) and "K3
    fp32"."""
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev).manual_seed(4)

    def case(shape, dtype, causal):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        o, lse = flash_fwd_cuda(q, k, v, causal, shape[-1] ** -0.5)
        delta = (do.float() * o.float()).sum(-1)
        return q, k, v, do, lse, delta

    def routed(fn, what, args, causal):
        """``fn`` (K2 or K3) on ``args``, checked to take its dtype's
        route."""
        before = route_counts(fn)
        out = fn(*args, causal, args[0].shape[-1] ** -0.5)
        took = [a - b for a, b in zip(route_counts(fn), before)]
        if took != routes_want(str(args[0].dtype).split(".")[1],
                               {what: 1})[what]:
            raise AssertionError(f"{what}: launch took the wrong route")
        return out

    def dkv(args, causal):
        return routed(flash_bwd_dkv_cuda, "K2", args, causal)

    def dq_(args, causal):
        return routed(flash_bwd_dq_cuda, "K3", args, causal)

    def check(shape, dtype, causal):
        name = str(dtype).split(".")[1]
        args = case(shape, dtype, causal)
        dk, dv = dkv(args, causal)
        dq = dq_(args, causal)
        q, k, v, do, lse, delta = args
        ref = flash_bwd_reference(q.float(), k.float(), v.float(),
                                  do.float(), lse, delta, causal=causal)
        # fp32: a second launch of each, bitwise the first (one owner
        # per output tile, no atomics)
        same = dtype is torch.bfloat16 or all(
            torch.equal(a, b)
            for a, b in zip((dk, dv, dq), (*dkv(args, causal),
                                           dq_(args, causal))))
        torch.cuda.synchronize()
        errs = {}
        for kname, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1]),
                                 ("dv", dv, ref[2])):
            errs[kname] = compare(got, want, name)
        ok = all(e[1] for e in errs.values()) and same
        log(f"K2/K3 flash_bwd {name} ({route(name)}) {list(shape)} "
            f"{'causal' if causal else 'full'}: max_abs_err "
            + ", ".join(f"{k} {e[0]:.3e}" for k, e in errs.items())
            + f" (atol, rtol {TOL[name]})"
            + ("" if dtype is torch.bfloat16 else
               f", two launches {'bitwise' if same else 'DIFFER'}")
            + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2/K3 disagree with flash_bwd_reference "
                                 f"or between launches at {name} {shape} "
                                 f"causal={causal}")
        return args, errs

    def sdpa_backward_ms(args):
        q, k, v, do = (x.detach().clone().requires_grad_() for x in args[:4])
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return time_ms(lambda: torch.autograd.grad(o, (q, k, v), do,
                                                   retain_graph=True),
                       flush=flush)

    def record(name, kname, args, err, ms, plain, lib):
        dtype_name = str(args[0].dtype).split(".")[1]
        b_ms, b_by = bwd_bound(kname, args[0], dtype_name)
        log(f"{name} times {dtype_name} {list(args[0].shape)}: kernel "
            f"{ms:.4f} ms, plain (dq+dk+dv) {plain:.4f} ms, sdpa backward "
            f"(pair) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return {
            "name": name, "route": "cuda",
            "source": "theanompi_tpu_torch/csrc/flash_bwd.cu",
            "replaces": ("theanompi_tpu/ops/attention.py:239"
                         if kname == "dkv" else
                         "theanompi_tpu/ops/attention.py:292"),
            "shape": f"{list(args[0].shape)} {dtype_name} causal",
            "launches": None, "max_abs_err": err, "ms": ms,
            # the plain version computes dq, dk and dv together; the
            # library call is the SDPA backward of the K2 + K3 pair
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib,
        }

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for t in (16, 512, 2047):
                args, errs = check((1, 32, t, 128), dtype, causal)
                if dtype is torch.float32 and causal and t == 2047:
                    plain = time_ms(lambda: flash_bwd_reference(
                        *args, causal=True), reps=5, flush=flush)
                    lib = sdpa_backward_ms(args)
                    records["K2 fp32"] = record(
                        "flash_bwd_dkv_tf32x3", "dkv", args,
                        max(errs["dk"][0], errs["dv"][0]),
                        time_ms(lambda: dkv(args, True), flush=flush),
                        plain, lib)
                    records["K3 fp32"] = record(
                        "flash_bwd_dq_tf32x3", "dq", args, errs["dq"][0],
                        time_ms(lambda: dq_(args, True), flush=flush),
                        plain, lib)
    args, errs = check((2, 32, 2048, 128), torch.bfloat16, True)
    plain = time_ms(lambda: flash_bwd_reference(*args, causal=True),
                    reps=5, flush=flush)
    lib = sdpa_backward_ms(args)
    records["K2"] = record(
        "flash_bwd_dkv_tc", "dkv", args, max(errs["dk"][0], errs["dv"][0]),
        time_ms(lambda: dkv(args, True), flush=flush), plain, lib)
    records["K3"] = record(
        "flash_bwd_dq_tc", "dq", args, errs["dq"][0],
        time_ms(lambda: dq_(args, True), flush=flush), plain, lib)
    return records


def check_sm_scale(dev) -> dict:
    """bf16 K1, K2 and K3 at sm_scale -0.125 and 0, causal and full, at
    [1, 32, 512, 128] against their plain versions evaluated in fp32
    (K1 launches -Q at 0.125 and Q = 0 at 1; K2 and K3 take the scale
    as it is), each launch on the bf16 tensor-core route.  Returns the
    max abs errors by scale and mask."""
    import torch

    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((1, 32, 512, 128), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    fns = {"K1": flash_fwd_cuda, "K2": flash_bwd_dkv_cuda,
           "K3": flash_bwd_dq_cuda}
    out = {}
    for scale in (-0.125, 0.0):
        for causal in (True, False):
            before = {k_: route_counts(f) for k_, f in fns.items()}
            o, lse = flash_fwd_cuda(q, k, v, causal, scale)
            delta = (do.float() * o.float()).sum(-1)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                        scale)
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
            took = {k_: [a - b for a, b in zip(route_counts(f), before[k_])]
                    for k_, f in fns.items()}
            o_ref, lse_ref = mha_reference_fwd(
                q.float(), k.float(), v.float(), causal=causal,
                sm_scale=scale)
            want = flash_bwd_reference(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta,
                                       causal=causal, sm_scale=scale)
            errs = {"o": compare(o, o_ref, "bfloat16"),
                    "lse": compare(lse, lse_ref, "float32"),
                    **{n: compare(g, w, "bfloat16")
                       for n, g, w in zip(("dq", "dk", "dv"),
                                          (dq, dk, dv), want)}}
            ok = all(e[1] for e in errs.values()) and took == routes_want(
                "bfloat16", {k_: 1 for k_ in fns})
            key = f"sm_scale {scale} {'causal' if causal else 'full'}"
            out[key] = {n: e[0] for n, e in errs.items()}
            log(f"K1/K2/K3 bfloat16 [1,32,512,128] {key}: max_abs_err "
                + ", ".join(f"{n} {e[0]:.3e}" for n, e in errs.items())
                + f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"bf16 K1-K3 at {key}: disagree with "
                                     f"the plain versions or took the "
                                     f"wrong route {took}")
    return out


def paged_bound(args) -> tuple[float, str, int]:
    """(bound ms, what bounds it, walked positions) of K4 on ``args``:
    the K/V bytes of every slot's blocks up to its last position, q and
    the output, tables and positions against 4*hd operations per walked
    position and query row (bf16 at its tensor-core rate, fp32 in three
    TF32 passes)."""
    q, kp, _, tables, pos = args
    s, nq, hkv, rep, hd = q.shape
    bs = kp.shape[2]
    walked = sum((int(p) // bs + 1) * bs for p in pos.max(dim=1).values)
    isz = q.element_size()
    nbytes = (2 * walked * hkv * hd * isz + 2 * q.numel() * isz
              + tables.numel() * 4 + pos.numel() * 4)
    name = str(q.dtype).split(".")[1]
    b_ms, b_by = bound(4 * walked * hkv * rep * nq * hd, nbytes,
                       "tf32x3" if name == "float32" else name)
    return b_ms, b_by, walked


def paged_route(args, ctas=None):
    """K4 on ``args``, checked to take its dtype's split kernel (bf16:
    ``.tc_launches``, fp32: ``.tf32x3_launches``)."""
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    before = route_counts(paged_attend_cuda)
    out = paged_attend_cuda(*args, ctas=ctas)
    took = [a - b for a, b in zip(route_counts(paged_attend_cuda), before)]
    name = str(args[0].dtype).split(".")[1]
    if took != routes_want(name, {"K4": 1})["K4"]:
        raise AssertionError(f"K4 {name}: launch took the wrong route")
    return out


def check_paged(dev, flush) -> dict:
    """K4 against the gather path evaluated in fp32, both dtypes, at the
    decode shape (S=8, Q=1, Hkv=8, rep=4, hd=128, bs=16, MB=128), the
    16-row verify shape (Q=4) and past one row group of 16: 20, 32 and
    64 rows (Q = 5, 8, 16; ``speculate_k`` 8 gives 32), each launch
    checked to take its dtype's split kernel (bf16: tensor cores, fp32:
    three TF32 passes); both timed at 4, 16 and 32 rows.  At a tp = 2
    rank's 4 kv heads (Q = 1 and 4): the 8-head inputs' heads 4-7, fp32
    bitwise those heads of the 8-head launch.  fp32 also: a second
    launch bitwise the first, each slot alone bitwise its batched
    output, and a 32-row launch whose rows 16-31 repeat rows 0-15's
    positions bitwise the 16-row launch in rows 0-15.  At the decode
    shape each record also holds the split length the built library
    reports and the CTAs its split kernel counted on the card in one
    call: launched, and live (not exited early).  Returns the records
    keyed "K4" (bf16) and "K4 fp32"."""
    import torch

    from theanompi_tpu_torch.kernels.tune import paged_inputs
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_reference,
        split_len,
    )

    def bitwise(what, a, b):
        same = torch.equal(a, b)
        log(f"K4 float32 {what}: {'bitwise' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"K4 float32: {what} differ")

    gen = torch.Generator(device=dev).manual_seed(2)
    records = {"K4": {}, "K4 fp32": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        fp32 = dtype is torch.float32
        record = records["K4 fp32" if fp32 else "K4"]
        wide = record["past_16_rows"] = {}
        full = {}
        for nq in (1, 4, 5, 8, 16):
            args = full[nq] = paged_inputs(dev, dtype, gen, nq)
            out = paged_route(args)
            ref = paged_attend_reference(
                *(a.float() if a.is_floating_point() else a for a in args))
            torch.cuda.synchronize()
            err, ok = compare(out, ref, name)
            log(f"K4 paged_attend {name} S=8 Q={nq} Hkv=8 rep=4 hd=128 "
                f"bs=16 MB=128: max_abs_err {err:.3e} (atol, rtol "
                f"{TOL[name]}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K4 disagrees with the gather path "
                                     f"at {name} Q={nq}")
            if fp32 and nq in (1, 4):
                bitwise(f"Q={nq} two launches", out, paged_route(args))
            if fp32 and nq == 1:
                q, kp, vp, tables, pos = args
                alone = torch.cat([
                    paged_route((q[i:i + 1], kp, vp, tables[i:i + 1],
                                 pos[i:i + 1])) for i in range(q.shape[0])])
                bitwise("each slot alone and batched", alone, out)
            if nq > 4:
                wide.setdefault(f"{4 * nq} rows", {})["max_abs_err"] = err
            if nq in (5, 16):
                continue
            ms = time_ms(lambda: paged_route(args), flush=flush)
            plain = time_ms(lambda: paged_attend_reference(*args),
                            flush=flush)
            b_ms, b_by, walked = paged_bound(args)
            log(f"K4 times {name} Q={nq} ({4 * nq} rows): kernel {ms:.4f} "
                f"ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{walked} walked positions)")
            at = {"shape": f"S=8 Q={nq} Hkv=8 rep=4 hd=128 bs=16 MB=128 "
                           f"{name} ({4 * nq} rows)",
                  "max_abs_err": err, "ms": ms, "plain_ms": plain,
                  "bound_ms": b_ms, "bound_by": b_by}
            if nq == 8:
                wide["32 rows"].update(at)
                continue
            if nq == 4:
                record["verify_shape"] = at
                continue
            counted = torch.zeros(2, dtype=torch.int32, device=dev)
            paged_route(args, ctas=counted)
            launched, live = counted.tolist()
            record.update(at, **{
                "name": "paged_split_tf32x3" if fp32 else "paged_attend",
                "route": "cuda",
                "source": "theanompi_tpu_torch/csrc/paged_attend.cu",
                "replaces": "theanompi_tpu/serving/paged_attention.py:67",
                "launches": None, "library_ms": None,
                "split_len": split_len(),
                "ctas": {"launched": launched, "live": live}})
            log(f"K4 {name} splits of {record['split_len']} positions: "
                f"{launched} CTAs launched, {live} live (counted on the "
                f"card)")
        if fp32:
            # rows 16-31 at rows 0-15's positions: the same splits live
            q, kp, vp, tables, pos = full[8]
            pos = pos.clone()
            pos[:, 4:] = pos[:, :4]
            both = paged_route((q, kp, vp, tables, pos))
            half = paged_route((q[:, :4].contiguous(), kp, vp, tables,
                                pos[:, :4].contiguous()))
            bitwise("rows 0-15 of a 32-row launch and the 16-row launch",
                    both[:, :4], half)
        log(f"K4 {name} past one row group of 16: {json.dumps(wide)}")
        # serving_tp at tp = 2: a rank's 4 of the 8 kv heads
        rank = record["tp_rank_shape"] = {}
        for nq in (1, 4):
            q, kp, vp, tables, pos = full[nq]
            whole = paged_route(full[nq])
            args = (q[:, :, 4:].contiguous(), kp[:, 4:].contiguous(),
                    vp[:, 4:].contiguous(), tables, pos)
            out = paged_route(args)
            ref = paged_attend_reference(
                *(a.float() if a.is_floating_point() else a for a in args))
            err, ok = compare(out, ref, name)
            same = torch.equal(out, whole[:, :, 4:])
            rank[f"S=8 Q={nq} Hkv=4 rep=4 {name}"] = err
            log(f"K4 paged_attend {name} S=8 Q={nq} Hkv=4 rep=4 hd=128 "
                f"bs=16 MB=128 (a tp = 2 rank): max_abs_err {err:.3e}, "
                f"{'bitwise' if same else 'not bitwise'} the 8-head "
                f"launch's heads 4-7 -> {'ok' if ok else 'FAIL'}")
            if not ok or (fp32 and not same):
                raise AssertionError(f"K4 disagrees with the gather path "
                                     f"or the 8-head launch at {name} "
                                     f"Q={nq} Hkv=4")
        del full
    return records


def ulp_bf16(ref):
    """One bf16 ulp at each value of ``ref`` (fp32): 2**(exponent - 7)."""
    import torch

    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_rms_norm(dev, flush) -> dict:
    """The serving RMS norm kernel against its plain version at the
    serving shapes (8 rows a v1 decode step; 64 a paged decode or verify
    step, the decoder's one product row count, and a prefill chunk;
    4096 wide), also at 32 rows, within one bf16 ulp in bf16 and 1e-6
    (absolute plus relative) in fp32; a row's output bitwise the same in
    launches of 1, 8 and 64 rows; times at 8 x 4096 and 64 x 4096 bf16
    (kernel, plain version, and ``F.rms_norm`` where PyTorch has it).
    Returns the kernel's record."""
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops.norm import rms_norm, rms_norm_cuda

    gen = torch.Generator(device=dev).manual_seed(4)
    d = 4096
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for rows in (8, 32, 64):
            x = (torch.randn((rows, d), generator=gen, device=dev) * 3
                 ).to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)
                 ).to(dtype)
            got, ref = rms_norm_cuda(x, w).float(), rms_norm(x, w).float()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            lim = (ulp_bf16(ref) if dtype == torch.bfloat16
                   else 1e-6 * (1 + ref.abs()))
            ok = bool((err <= lim).all())
            tol = "one bf16 ulp" if name == "bfloat16" else "1e-6 abs + rel"
            log(f"rms_norm {name} [{rows}, {d}]: max_abs_err "
                f"{err.max().item():.3e} ({tol}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"rms_norm disagrees with its plain "
                                     f"version at {name} [{rows}, {d}]")
            if dtype == torch.bfloat16:
                worst = max(worst, err.max().item())
        x = torch.randn((64, d), generator=gen, device=dev).to(dtype)
        full = rms_norm_cuda(x, w)
        same = torch.equal(full[:8], rms_norm_cuda(x[:8].contiguous(), w))
        for r in (0, 7, 8, 31, 63):
            same &= torch.equal(full[r:r + 1],
                                rms_norm_cuda(x[r:r + 1].contiguous(), w))
        log(f"rms_norm {name}: rows of a 64-row launch bitwise those of "
            f"8- and 1-row launches: {same}")
        if not same:
            raise AssertionError(f"rms_norm {name}: a row depends on the "
                                 f"launch's row count")
    wide = check_rms_norm_wide(dev, gen)
    times = {}
    for rows in (8, 64):
        x = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        w = torch.ones(d, device=dev, dtype=torch.bfloat16)
        lib = (time_ms(lambda: F.rms_norm(x, (d,), w, 1e-5), flush=flush)
               if hasattr(F, "rms_norm") else None)
        # x read and the output written once, w once; the fp32 math
        # (square, sum, scale, weight) on the CUDA cores
        b_ms, b_by = bound(4 * rows * d, (2 * rows * d + d) * 2, "float32")
        times[rows] = dict(
            ms=time_ms(lambda: rms_norm_cuda(x, w), flush=flush),
            plain_ms=time_ms(lambda: rms_norm(x, w), flush=flush),
            library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        log(f"rms_norm times bf16 [{rows}, {d}]: {json.dumps(times[rows])}")
    return {
        "name": "rms_norm", "route": "cuda",
        "source": "theanompi_tpu_torch/csrc/rms_norm.cu",
        "replaces": "theanompi_tpu/models/llama.py:91",
        "note": "not a TPU kernel: the serving norm, row-count "
                "independent (repairs speculative equality)",
        "shape": "[8, 4096] bf16 (a v1 decode step; a paged decode or "
                 "verify step [64, 4096] in verify_shape)",
        "launches": None, "max_abs_err": worst, **times[8],
        "verify_shape": {"shape": "[64, 4096] bf16", **times[64]},
        "d_16384": wide,
    }


def check_rms_norm_wide(dev, gen) -> dict:
    """The norm kernel past the 8192 columns of Llama widths: [32,
    16384] in both dtypes against its plain version (one bf16 ulp, or
    1e-6 absolute plus relative in fp32; how many bf16 elements are
    bitwise equal is printed), a row bitwise the same in launches of 1,
    8 and 32 rows."""
    import torch

    from theanompi_tpu_torch.ops.norm import rms_norm, rms_norm_cuda

    d, out = 16384, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = (torch.randn((32, d), generator=gen, device=dev) * 3).to(dtype)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        got = rms_norm_cuda(x, w)
        ref = rms_norm(x, w)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        lim = (ulp_bf16(ref.float()) if dtype == torch.bfloat16
               else 1e-6 * (1 + ref.float().abs()))
        ok = bool((err <= lim).all())
        same = torch.equal(got[:8], rms_norm_cuda(x[:8].contiguous(), w))
        for r in (0, 9, 31):
            same &= torch.equal(got[r:r + 1],
                                rms_norm_cuda(x[r:r + 1].contiguous(), w))
        out[name] = {"max_abs_err": err.max().item(),
                     "bitwise_equal_share":
                         (got == ref).float().mean().item(),
                     "rows_independent": bool(same)}
        log(f"rms_norm {name} [32, {d}]: {json.dumps(out[name])} -> "
            f"{'ok' if ok and same else 'FAIL'}")
        if not (ok and same):
            raise AssertionError(f"rms_norm {name} at d={d}: against its "
                                 f"plain version {ok}, rows independent "
                                 f"{same}")
    return out


# -- serving -----------------------------------------------------------------

SMALL = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
             vocab=512, seq_len=256, compute_dtype="float32", seed=5)


def serve(dec, prompts, *, max_tokens, seeds, prefix_caching=True):
    """Submit every prompt to one engine over ``dec``, run it until
    idle, and return (token lists, recorder summary, paging stats,
    wall seconds).  Raises unless every request resolved ``ok`` with
    ``max_tokens`` tokens."""
    import torch

    from theanompi_tpu_torch.serving import Engine

    eng = Engine(dec, prefix_caching=prefix_caching)
    futs = [eng.submit(p, max_tokens=max_tokens, seed=s)
            for p, s in zip(prompts, seeds)]
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = []
    for i, f in enumerate(futs):
        if not f.done():
            raise AssertionError(f"request {i} never resolved")
        r = f.result(timeout=0)
        if r.status != "ok" or len(r.tokens) != max_tokens:
            raise AssertionError(
                f"request {i}: {r.status}/{r.finish_reason}, "
                f"{len(r.tokens)} tokens"
            )
        if not all(0 <= t < dec.model.vocab for t in r.tokens):
            raise AssertionError(f"request {i}: token id out of range")
        out.append(r.tokens)
    return out, eng.recorder.summary(), eng.paging_stats(), wall


def small_pair(dev):
    """The small fp32 model on the card, and a copy of its weights on
    the CPU."""
    from theanompi_tpu_torch.models import Llama

    gpu = Llama(SMALL, device=dev)
    cpu_params = {
        "embed": gpu.params["embed"].cpu(),
        "layers": [{k: t.cpu() for k, t in lp.items()}
                   for lp in gpu.params["layers"]],
        "final_norm": gpu.params["final_norm"].cpu(),
        "lm_head": gpu.params["lm_head"].cpu(),
    }
    return gpu, Llama(SMALL, device="cpu", params=cpu_params)


def check_reference(dev) -> None:
    """A small fp32 model served on the card (through both kernels) and
    on the CPU (through their plain versions), same weights and
    prompts: the greedy ids must agree."""
    import numpy as np

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, SMALL["vocab"], size=n).tolist()
               for n in (5, 17, 40, 100)]
    gpu, cpu = small_pair(dev)
    for paged in (False, True):
        kw = dict(max_slots=4, max_seq=128)
        if paged:
            kw.update(block_size=16, prefill_chunk=32)
        ids = [serve(m.make_decoder(paged=paged, **kw), prompts,
                     max_tokens=12, seeds=range(4))[0] for m in (gpu, cpu)]
        name = "paged" if paged else "v1"
        same = ids[0] == ids[1]
        log(f"reference [{name}] small fp32 model, card vs CPU greedy "
            f"ids: {'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name}: card and CPU ids differ: {ids}")


def make_requests(vocab: int):
    """12 prompts of 16-1500 tokens, then 4 sharing a 256-token system
    prompt (the paged phase's prefix-cache traffic), from a seed."""
    import numpy as np

    rng = np.random.default_rng(3)
    lengths = rng.integers(16, 1501, size=12)
    prompts = [rng.integers(0, vocab, size=int(n)).tolist()
               for n in lengths]
    system = rng.integers(0, vocab, size=256).tolist()
    shared = [system + rng.integers(0, vocab, size=int(n)).tolist()
              for n in rng.integers(16, 200, size=4)]
    return prompts, shared


def add_launches(record: dict, **by_path) -> None:
    """Add main-path launch counts to a kernel's record: its
    ``launches`` is the sum over every path counted."""
    paths = record.setdefault("launches_by_path", {})
    paths.update(by_path)
    record["launches"] = sum(paths.values())


def reset_counts(*wrappers) -> None:
    """Zero each kernel wrapper's launch counts (all routes, all row
    counts)."""
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0
        if hasattr(fn, "tf32x3_launches"):
            fn.tf32x3_launches = 0
        if hasattr(fn, "launches_by_rows"):
            fn.launches_by_rows = {}


def count_fp32_k4(records: dict, path: str, run, dev) -> None:
    """``run(dev)``, a small fp32 model's path, with K4's counts reset
    just before: every launch must take the three-pass TF32 route, and
    their count goes to the "K4 fp32" record under ``path``."""
    from theanompi_tpu_torch.serving.paged_attention import paged_attend_cuda

    reset_counts(paged_attend_cuda)
    run(dev)
    n = paged_attend_cuda.launches
    if not n or route_counts(paged_attend_cuda) != routes_want(
            "float32", {"K4": n})["K4"]:
        raise AssertionError(f"{path}: fp32 K4 launches, bf16 tensor-core, "
                             f"three-pass TF32 "
                             f"{route_counts(paged_attend_cuda)}")
    add_launches(records.setdefault("K4 fp32", {}), **{path: n})


def check_tc_route(what: str, fn) -> None:
    """Every launch of ``fn`` counted since its reset took the
    tensor-core kernel (the bf16 route)."""
    if fn.tc_launches != fn.launches:
        raise AssertionError(
            f"{what}: {fn.launches - fn.tc_launches} of {fn.launches} "
            f"{fn.__name__} launches missed the tensor-core route")


def run_serving(name, dec, prompts, alone_idx, counter) -> dict:
    """Drive one decoder through the engine: every prompt batched with
    ``counter`` (a kernel wrapper) reset just before and read just
    after, then a few prompts again alone; ids must agree.  A counter
    with a tensor-core route must have taken it every time.  The RMS
    norm kernel is counted over the batched run too: one launch a norm,
    2 a layer and the final one, every prefill and decode call."""
    from theanompi_tpu_torch.ops.norm import rms_norm_cuda

    card = card_line()
    seeds = list(range(len(prompts)))
    reset_counts(counter, rms_norm_cuda)
    calls = [Count(dec, "prefill"), Count(dec, "decode")]
    ids, summ, stats, wall = serve(dec, prompts, max_tokens=32, seeds=seeds)
    for c in calls:
        c.undo()
    launches, norms = counter.launches, rms_norm_cuda.launches
    want = norm_launches_per_call(dec.model) * sum(c.n for c in calls)
    log(f"[{name}] {len(prompts)} requests batched in {wall:.2f} s; "
        f"{counter.__name__} launches {launches}, rms_norm_cuda launches "
        f"{norms} ({want} = {norm_launches_per_call(dec.model)} x "
        f"{sum(c.n for c in calls)} prefill and decode calls)")
    if launches <= 0:
        raise AssertionError(f"{name}: {counter.__name__} never launched")
    if norms != want:
        raise AssertionError(f"{name}: rms_norm launches {norms}, want "
                             f"{want}")
    if hasattr(counter, "tc_launches"):
        check_tc_route(name, counter)
    alone = [serve(dec, [prompts[i]], max_tokens=32, seeds=[seeds[i]],
                   prefix_caching=False)[0][0] for i in alone_idx]
    same = all(a == ids[i] for a, i in zip(alone, alone_idx))
    log(f"[{name}] requests {list(alone_idx)} alone vs batched ids: "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{name}: batched ids differ from alone ids")
    keys = ("n_completed", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s",
            "tpot_p95_s", "tokens_per_sec", "slot_occupancy",
            "prefix_hit_tokens", "prefix_hit_rate")
    log(f"[{name}] {json.dumps({k: summ[k] for k in keys})} on {card}")
    if stats is not None:
        log(f"[{name}] paging {json.dumps(stats)}")
    return {"launches": launches, "norm_launches": norms, "summary": summ,
            "stats": stats, "wall_s": wall}


#: whether this run has held ``device_kernels``' raw reading against
#: ``key_averages`` yet
_KERNELS_CHECKED: list = []


def device_kernels(prof) -> list:
    """(name, device ms) of each kernel of a ``torch.profiler`` run,
    largest first, summed from the profiler's raw kineto events
    (``key_averages`` first builds a Python event tree: seconds a
    profile).  The port's registered ranges (``obs.scope``) also carry
    the device time of the kernels under them (kineto's
    ``gpu_user_annotation``): they are not kernels, and are left out so
    that no kernel counts twice.  The first call of a run also reads
    ``key_averages`` and fails unless the two agree."""
    import torch

    from theanompi_tpu_torch.obs import profile_scope_sets

    cuda = torch.autograd.DeviceType.CUDA
    ns = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ns[e.name()] = ns.get(e.name(), 0) + e.duration_ns()
    out = sorted(((k, v / 1e6) for k, v in ns.items()
                  if v > 0 and not profile_scope_sets([k])),
                 key=lambda kv: -kv[1])
    if not _KERNELS_CHECKED:
        ref = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0
               and not profile_scope_sets([e.key])}
        got = dict(out)
        bad = [k for k in set(ref) | set(got)
               if abs(got.get(k, 0.0) - ref.get(k, 0.0))
               > 1e-3 * abs(ref.get(k, 0.0)) + 1e-2]
        if bad:
            raise AssertionError(f"device_kernels: the raw events and "
                                 f"key_averages disagree at {bad[:5]}")
        _KERNELS_CHECKED.append(len(ref))
    return out


def trace_steps(step, steps: int, top: int) -> tuple[dict, list]:
    """Run ``step(i)`` for ``steps`` steps twice: once timed on the wall
    clock alone (the profiler's own cost excluded), once under
    ``torch.profiler``.  Returns (wall ms per step, device kernel ms per
    step, busy share = device / wall and the ``top`` kernels with the
    most device time; every kernel's (name, device ms per step),
    largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed_steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall_ms = timed_steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_steps()
    kernels = [(k, ms / steps) for k, ms in device_kernels(prof)]
    dev_ms = sum(ms for _, ms in kernels)
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_ms,
        "device_ms_per_step": dev_ms,
        "busy_share": dev_ms / wall_ms if wall_ms else None,
        "top_kernels_ms_per_step": {k[:80]: ms for k, ms in kernels[:top]},
    }, kernels


def profile_decode(name, dec, prompts, steps: int = 8, **ekw) -> dict:
    """Where a decode step's time goes: fill every slot, run engine
    steps until no slot is prefilling, then trace ``steps`` decode-only
    steps as ``trace_steps`` does (``ekw``: more ``Engine`` keywords;
    with ``speculate_k`` the steps are verify steps)."""
    from theanompi_tpu_torch.serving import Engine

    eng = Engine(dec, prefix_caching=False, **ekw)
    for i, p in enumerate(prompts[:dec.max_slots]):
        eng.submit(p[:1024], max_tokens=dec.max_seq, seed=i)
    eng.step()
    while eng.n_prefilling():
        eng.step()

    out, kernels = trace_steps(lambda i: eng.step(), steps, top=6)
    eng.abandon_all()               # free the slots: the decoder serves on
    out = {"decoder": name, **out}
    if dec.paged:
        # K4 is its split and merge kernels
        k4 = sum(ms for k, ms in kernels if kernel_kind(k).startswith("K4"))
        out["k4_ms_per_step"] = k4
        out["k4_share_of_device"] = k4 / out["device_ms_per_step"]
    log(f"[{name}] decode profile {json.dumps(out)} on {card_line()}")
    return out


def decode_rate(eng, steps: int) -> float:
    """Decode tokens/s of ``steps`` engine steps over full slots."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    return steps * eng.decoder.max_slots / (time.perf_counter() - t0)


def profile_decode_scopes(dec, prompts, steps: int = 8, reps: int = 3
                          ) -> dict:
    """The paged decode's legs through the port's ``comm_report``: the
    shares of the device time under ``serving_sample``, ``paged_attend``
    and ``kv_write`` over ``steps`` traced decode steps (all three
    asserted above 0); then decode tokens/s with the ranges as they
    ship (one profiler check each) against none at all, in turns, ``reps``
    times each: the ranges' cost while nobody profiles, the medians'
    difference, held to ``RANGE_COST_RTOL`` or the no-range arm's own
    spread, whichever is larger (the decode is host-bound)."""
    import contextlib

    from theanompi_tpu_torch.obs import profile_scope_sets
    from theanompi_tpu_torch.serving import Engine
    from theanompi_tpu_torch.serving import decoder as decoder_mod
    from theanompi_tpu_torch.utils import trace_comm

    eng = Engine(dec, prefix_caching=False)
    for i, p in enumerate(prompts[:dec.max_slots]):
        eng.submit(p[:1024], max_tokens=dec.max_seq, seed=i)
    eng.step()
    while eng.n_prefilling():
        eng.step()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
        trace_comm.capture_trace(lambda: [eng.step() for _ in range(steps)],
                                 td)
        scopes = profile_scope_sets(trace_comm.range_labels(td))
        rep = trace_comm.comm_report(td, scopes=scopes)
    busy = rep["device_busy_s"]
    shares = {leg: rep["scope_s"].get(leg, 0.0) / busy
              for leg in ("sample", "attend", "kv_write")}
    rates = {"ranges": [], "none": []}
    shipped = decoder_mod.scope
    try:
        for _ in range(reps):
            for arm in ("ranges", "none"):
                decoder_mod.scope = (shipped if arm == "ranges" else
                                     lambda label: contextlib.nullcontext())
                rates[arm].append(decode_rate(eng, 2 * steps))
    finally:
        decoder_mod.scope = shipped
    eng.abandon_all()
    out = {"steps": steps, "device_ms_per_step": busy * 1e3 / steps,
           "shares_of_device": shares,
           "legs_ms_per_step": {leg: rep["scope_s"].get(leg, 0.0) * 1e3 / steps
                                for leg in ("sample", "attend", "kv_write")},
           "tokens_per_s": rates}
    med = {k: statistics.median(v) for k, v in rates.items()}
    out["range_cost"] = med["none"] / med["ranges"] - 1
    out["noise"] = (max(rates["none"]) - min(rates["none"])) / med["none"]
    log(f"[paged] decode scopes {json.dumps(out)} on {card_line()}")
    if not all(v > 0 for v in shares.values()):
        raise AssertionError(f"paged: serving legs {shares}")
    if out["range_cost"] > max(RANGE_COST_RTOL, out["noise"]):
        raise AssertionError(f"paged: the ranges cost {out['range_cost']:.2%} "
                             f"of decode tokens/s with no profiler")
    return out


# -- serving_ext: speculation, KV handoffs, tracing, the tokenizer ----------

SPEC_K = 4             # the JAX bench's default window: 16 K4 rows at rep 4
SPEC_K_WIDE = 8        # 32 K4 rows at rep 4: two row groups of 16


def small_ext_prompts(vocab: int) -> list:
    """Prompts for the small model's serving_ext checks: two that repeat
    a short motif (what self-drafting feeds on) and two random ones."""
    import numpy as np

    rng = np.random.default_rng(17)
    motifs = [rng.integers(0, vocab, size=m).tolist() for m in (3, 5)]
    return ([(motifs[0] * 10)[:20], (motifs[1] * 20)[:70]]
            + [rng.integers(0, vocab, size=n).tolist() for n in (9, 33)])


def ext_run(dec, prompts, *, max_tokens=32, handoffs=None,
            prefill_only=False, temperature=0.0, **ekw):
    """Serve every prompt (request i with seed i at ``temperature``, and
    ``handoffs[i]`` when given) through one ``Engine(dec, prefix_caching=False,
    **ekw)`` until idle.  Returns (results, engine, wall seconds); raises
    unless every request finished as asked with ids in the vocab."""
    import torch

    from theanompi_tpu_torch.serving import Engine, Request

    eng = Engine(dec, prefix_caching=False, **ekw)
    futs = [eng.submit(Request(
        prompt=list(p), max_tokens=max_tokens, seed=i,
        temperature=temperature, prefill_only=prefill_only,
        handoff=handoffs[i] if handoffs else None))
        for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    eng.run_until_idle()
    if dec.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = ("prefilled", 1) if prefill_only else ("max_tokens", max_tokens)
    out = []
    for i, f in enumerate(futs):
        r = f.result(timeout=0)
        if (r.status, r.finish_reason, len(r.tokens)) != ("ok", *want):
            raise AssertionError(f"request {i}: {r.status}/"
                                 f"{r.finish_reason}, {len(r.tokens)} "
                                 f"tokens, want {want}")
        if not all(0 <= t < dec.model.vocab for t in r.tokens):
            raise AssertionError(f"request {i}: token id out of range")
        out.append(r)
    return out, eng, wall


class Calls:
    """Counts the calls of one decoder method and times each on the
    host clock with the device synchronized after it (patched on the
    instance; ``undo`` restores the class's method)."""

    def __init__(self, obj, name: str):
        import torch

        fn = getattr(obj, name)
        self.ms: list = []

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, name, timed)
        self.undo = lambda: delattr(obj, name)

    @property
    def n(self) -> int:
        return len(self.ms)


class Count:
    """Counts the calls of one method on an instance (patched on the
    instance, no synchronization; ``undo`` restores the class's)."""

    def __init__(self, obj, name: str):
        fn = getattr(obj, name)
        self.n = 0

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)

        setattr(obj, name, counted)
        self.undo = lambda: delattr(obj, name)


def norm_launches_per_call(model) -> int:
    """RMS norm launches of one decoder call (a prefill chunk, a decode
    or a verify step): two a layer and the final norm."""
    return 2 * model.n_layers + 1


def profile_norm_ab(dec, prompts, steps: int = 4) -> dict:
    """The decode step's profile (``trace_steps``, as ``profile_decode``
    gives it) with every serving norm through the kernel and through the
    plain expression it replaced (PyTorch's mean over the row), in turns
    plain, kernel, kernel, plain, over one engine's full decode batch:
    device and wall ms a step, busy share, the norm kernel's ms a step;
    the last kernel turn's top kernels and K4's share."""
    import theanompi_tpu_torch.serving.decoder as decoder_mod
    from theanompi_tpu_torch.ops.norm import rms_norm, rms_norm_rows
    from theanompi_tpu_torch.serving import Engine

    eng = Engine(dec, prefix_caching=False)
    for i, p in enumerate(prompts[:dec.max_slots]):
        eng.submit(p[:1024], max_tokens=dec.max_seq, seed=i)
    eng.step()
    while eng.n_prefilling():
        eng.step()
    out = {"plain": [], "kernel": []}
    try:
        for mode in ("plain", "kernel", "kernel", "plain"):
            decoder_mod.rms_norm_rows = (rms_norm if mode == "plain"
                                         else rms_norm_rows)
            prof, kernels = trace_steps(lambda i: eng.step(), steps, top=6)
            norm_ms = sum(ms for k, ms in kernels
                          if kernel_kind(k) == "rms_norm")
            out[mode].append({
                "device_ms_per_step": prof["device_ms_per_step"],
                "wall_ms_per_step": prof["wall_ms_per_step"],
                "busy_share": prof["busy_share"],
                "rms_norm_kernel_ms_per_step": norm_ms})
            if mode == "kernel":
                k4 = sum(ms for k, ms in kernels
                         if kernel_kind(k).startswith("K4"))
                out["kernel_top_kernels_ms_per_step"] = prof[
                    "top_kernels_ms_per_step"]
                dev_ms = prof["device_ms_per_step"]
                out["kernel_k4_share_of_device"] = (k4 / dev_ms if dev_ms
                                                    else None)
    finally:
        decoder_mod.rms_norm_rows = rms_norm_rows
        eng.abandon_all()
    log(f"[serving_ext norm a/b] decode step, 8 slots, "
        f"{dec.model.n_layers} layers: {json.dumps(out)} on {card_line()}")
    return out


def verify_matrix(dec, prompts):
    """Prefill each prompt into its own slot, then one verify step over
    windows [first token, the prompt's last 3 tokens]: the [S, K] token
    matrix."""
    import numpy as np

    mgr = dec.manager
    s = dec.max_slots
    tokens = np.zeros((s, SPEC_K), np.int64)
    lengths = np.zeros((s,), np.int64)
    n_valid = np.zeros((s,), np.int64)
    for slot, p in enumerate(prompts[:s]):
        mgr.assign(slot, [], mgr.blocks_for(len(p) + SPEC_K))
        pos, tok = 0, None
        while pos < len(p):
            c = min(dec.prefill_chunk, len(p) - pos)
            tok = dec.prefill(mgr.tables[slot], p[pos:pos + c], pos, c,
                              slot, 0.0)
            pos += c
        tokens[slot] = [int(tok)] + p[-(SPEC_K - 1):]
        lengths[slot] = len(p)
        n_valid[slot] = SPEC_K
    out = dec.verify(tokens, lengths, np.arange(s), np.zeros(s, np.float32),
                     mgr.tables, n_valid)
    for slot in range(min(s, len(prompts))):
        mgr.free_slot(slot)
    return out


def check_serving_ext_reference(dev) -> None:
    """The small fp32 model on the card and on the CPU from one init:
    speculative (k = SPEC_K) greedy ids equal one-token decode's on each
    device and the card's equal the CPU's; ``verify``'s token matrix is
    equal on both; a prompt prefilled ``prefill_only`` on decoder A and
    decoded from its handoff on decoder B gives the unified ids; a
    traced engine gives one connected span tree per request."""
    import numpy as np

    from theanompi_tpu_torch.obs import span_tree

    gpu, cpu = small_pair(dev)
    prompts = small_ext_prompts(SMALL["vocab"])
    kw = dict(max_slots=4, max_seq=128, block_size=16, prefill_chunk=32)
    ids, mats = {}, {}
    for name, m in (("card", gpu), ("cpu", cpu)):
        plain = [r.tokens for r in ext_run(m.make_decoder(paged=True, **kw),
                                           prompts, max_tokens=16)[0]]
        rs, eng, _ = ext_run(m.make_decoder(paged=True, **kw), prompts,
                             max_tokens=16, speculate_k=SPEC_K)
        summ = eng.recorder.summary()
        same = [r.tokens for r in rs] == plain
        log(f"reference [serving_ext] small fp32 model on the {name}: "
            f"speculative vs one-token greedy ids "
            f"{'equal' if same else 'DIFFER'} (accept rate "
            f"{summ['accept_rate']}, tokens per step "
            f"{summ['tokens_per_step']})")
        if not same:
            raise AssertionError(f"serving_ext {name}: speculative ids "
                                 f"differ from one-token decode's")
        ids[name] = plain
        mats[name] = verify_matrix(m.make_decoder(paged=True, **kw), prompts)
    same = ids["card"] == ids["cpu"]
    same_mat = np.array_equal(mats["card"], mats["cpu"])
    log(f"reference [serving_ext] card vs CPU: greedy ids "
        f"{'equal' if same else 'DIFFER'}; verify matrices "
        f"{'equal' if same_mat else 'DIFFER'}")
    if not (same and same_mat):
        raise AssertionError(f"serving_ext: card and CPU differ: ids "
                             f"{ids}, verify {mats}")
    pre, _, _ = ext_run(gpu.make_decoder(paged=True, **kw), prompts,
                        max_tokens=16, prefill_only=True)
    got = [r.tokens for r in ext_run(
        gpu.make_decoder(paged=True, **kw), prompts, max_tokens=16,
        handoffs=[r.handoff for r in pre])[0]]
    log(f"reference [serving_ext] prefill on A, decode on B vs unified "
        f"ids on the card: {'equal' if got == ids['card'] else 'DIFFER'}")
    if got != ids["card"]:
        raise AssertionError("serving_ext: disaggregated ids differ")
    rs, _, _ = ext_run(gpu.make_decoder(paged=True, **kw), prompts,
                       max_tokens=16, trace_sample=1)
    trees = [span_tree(r.spans, r.spans[0]["trace_id"]) if r.spans else {}
             for r in rs]
    ok = all(t.get("connected") and t["root_name"] == "request"
             for t in trees)
    log(f"reference [serving_ext] traced engine on the card: "
        f"{[t.get('n_spans') for t in trees]} spans a request, each one "
        f"connected tree: {ok}")
    if not ok:
        raise AssertionError(f"serving_ext: span trees broken: {trees}")


def first_divergence(a: list, b: list):
    """(request, token index) of the first id where two runs' token
    lists differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return i, j
    return None


def mlp_ops(x, p, m: int) -> dict:
    """Each op of a layer's MLP, as the serving decoder runs it, on every
    row of ``x`` against the same op on its first ``m`` rows alone (the
    decode step's batch): the largest |difference| over those rows."""
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops.norm import rms_norm_rows

    def ops(x):
        xn = rms_norm_rows(x, p["mlp_norm"])
        gate, up = xn @ p["w_gate"], xn @ p["w_up"]
        h = F.silu(gate) * up
        return {"rms_norm": xn, "gate": gate, "up": up, "silu_mul": h,
                "down": h @ p["w_down"]}

    full, part = ops(x), ops(x[:m])
    return {k: (full[k][:m].float() - part[k].float()).abs().max().item()
            for k in full}


def equality_causes(dec, k: int = SPEC_K) -> dict:
    """What could make a verify row differ from decode at one position,
    each on random inputs at the serving shape of a ``k``-token window:
    K4 (every row of a 4k-row verify launch against the same row alone
    in a 4-row decode launch), the products of layer 0 and the head
    (rows 8-15 of an 8k-row product against an 8-row product of the
    same rows), and each op of layer 0's MLP (``mlp_ops``)."""
    import torch

    from theanompi_tpu_torch.kernels.tune import paged_inputs
    from theanompi_tpu_torch.serving.paged_attention import paged_attend_cuda

    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, tables, pos = paged_inputs(dev, torch.bfloat16, gen, k)
    o_verify = paged_attend_cuda(q, kp, vp, tables, pos)
    k4 = max(
        (o_verify[:, j:j + 1].float() - paged_attend_cuda(
            q[:, j:j + 1].contiguous(), kp, vp, tables,
            pos[:, j:j + 1].contiguous()).float()).abs().max().item()
        for j in range(k))
    s = dec.max_slots
    p = dec.model.params
    gemm = {}
    for name, w in dict(p["layers"][0], lm_head=p["lm_head"]).items():
        if w.dim() == 2:
            x = torch.randn((s * k, w.shape[0]), generator=gen,
                            device=dev).to(w.dtype)
            gemm[name] = ((x @ w)[s:2 * s].float()
                          - (x[s:2 * s] @ w).float()).abs().max().item()
    x = torch.randn((s * k, p["embed"].shape[1]), generator=gen,
                    device=dev).to(dec._cdtype)
    return {"speculate_k": k, "k4_rows_verify_vs_decode_max_abs": k4,
            "gemm_rows_m32_vs_m8_max_abs": gemm,
            "mlp0_ops_m32_vs_m8_max_abs": mlp_ops(x, p["layers"][0], s)}


def first_window(dec, prompt) -> dict:
    """From one state (``prompt`` prefilled into slot 0 alone), the
    decode step and the verify window the engine runs first (its first
    token, no draft: ``n_valid`` 1) at the same position: the largest
    |difference| of row 0's logits and of row 0's K4 output in layer 0,
    the logits' top-2 gap, and each op of layer 0's MLP on the window's
    own 32 input rows against the same op on its first 8 rows."""
    import numpy as np

    import theanompi_tpu_torch.serving.decoder as decoder_mod
    from theanompi_tpu_torch.serving.paged_attention import paged_attend

    mgr = dec.manager
    s, n = dec.max_slots, len(prompt)
    mgr.assign(0, [], mgr.blocks_for(n + SPEC_K))
    first = None
    for pos in range(0, n, dec.prefill_chunk):
        c = min(dec.prefill_chunk, n - pos)
        first = dec.prefill(mgr.tables[0], prompt[pos:pos + c], pos, c, 0,
                            0.0)
    sample, mlp = type(dec)._sample, type(dec)._mlp
    logits, k4, mlp_in = [], [], []

    def keep_logits(lg, *a, **k):
        logits.append(lg.float()[0].cpu())
        return sample(dec, lg, *a, **k)

    def keep_k4(q, *a):         # layer 0 of the decode, then the verify
        o = paged_attend(q, *a)
        if len(k4) < 2 and (not k4 or q.shape[1] != k4[0][0]):
            k4.append((q.shape[1], o[:, :1].clone()))
        return o

    calls = [0]

    def keep_mlp(p_, x, *a):    # layer 0 of the decode, then the verify
        if calls[0] in (0, dec.model.n_layers):
            mlp_in.append((x.clone(), p_))
        calls[0] += 1
        return mlp(dec, p_, x, *a)

    dec._sample, dec._mlp = keep_logits, keep_mlp
    decoder_mod.paged_attend = keep_k4
    try:
        tokens, lengths = np.zeros((s,), np.int64), np.zeros((s,), np.int64)
        zeros, temps = np.zeros((s,), np.int64), np.zeros((s,), np.float32)
        tokens[0], lengths[0] = int(first), n
        active = np.arange(s) == 0
        dec.decode(tokens, lengths, zeros, temps, mgr.tables, active)
        window = np.zeros((s, SPEC_K), np.int64)
        window[0, 0] = tokens[0]
        n_valid = np.zeros((s,), np.int64)
        n_valid[0] = 1
        dec.verify(window, lengths, zeros, temps, mgr.tables, n_valid)
    finally:
        del dec._sample, dec._mlp
        decoder_mod.paged_attend = paged_attend
        mgr.free_slot(0)
    top2 = logits[0].topk(2).values
    (xd, _), (xv, p0) = mlp_in
    return {"logits_row0_max_abs": (logits[0] - logits[1]).abs().max()
            .item(),
            "logits_top2_gap": (top2[0] - top2[1]).item(),
            "k4_layer0_row0_max_abs": (k4[0][1][0].float()
                                       - k4[1][1][0].float()).abs().max()
            .item(),
            "mlp0_in_row0_equal": bool((xd[0] == xv[0]).all()),
            "mlp0_ops_m32_vs_m8_max_abs": mlp_ops(xv, p0, s)}


def replay_alone(dec, prompt, max_tokens: int) -> dict:
    """Serve one request alone three times — one-token, speculative,
    one-token again — keeping the logits of every emitted token: for the
    speculative run and for the second one-token run, the first token
    whose logits differ bitwise from the first run's and the window row
    that emitted it."""
    import torch

    from theanompi_tpu_torch.serving import Engine

    sample = type(dec)._sample
    runs = []
    for k in (0, SPEC_K, 0):
        steps = []

        def keep(logits, *a, **kw):
            n = 1 if k == 0 else SPEC_K
            if logits.shape[0] == dec.max_slots * n:    # not a prefill
                steps.append(logits.float().reshape(dec.max_slots, n, -1)[0]
                             .cpu())
            return sample(dec, logits, *a, **kw)

        dec._sample = keep
        try:
            eng = Engine(dec, prefix_caching=False, speculate_k=k)
            fut = eng.submit(prompt, max_tokens=max_tokens)
            eng.run_until_idle()
        finally:
            del dec._sample
        rows = []               # (logits, window row) of tokens 1, 2, ...
        for lg, st in zip(steps, eng.recorder.steps):
            rows += [(lg[j], j) for j in range(st["tokens"])]
        runs.append((fut.result(timeout=0).tokens, rows))

    def against_first(ids, rows) -> dict:
        ids0, rows0 = runs[0]
        first = next((i for i, ((a, _), (b, _)) in enumerate(zip(rows0, rows))
                      if not torch.equal(a, b)), None)
        out = {"ids_equal": ids == ids0,
               "first_token_with_other_logits": None if first is None
               else first + 1}
        if first is not None:
            a, (b, j) = rows0[first][0], rows[first]
            out.update(window_row=j, max_abs_logit_diff=(a - b).abs().max()
                       .item())
        return out

    return {"speculative": against_first(*runs[1]),
            "one_token_again": against_first(*runs[2])}


def run_serving_ext(dev, n_layers: int | None, records: dict) -> float:
    """Phase serving_ext at Llama-3-8B width, bf16, ``n_layers`` deep
    under ``PagedLlamaDecoder``, phase 4's 16 requests (32 tokens each,
    prefix caching off so every run does the same work): one-token
    decode, then ``speculate_k = SPEC_K`` off the same decoder (K4
    launched at 16 rows by every verify step), then prefill on a second
    decoder and decode from the handoffs, then tracing on and off and
    the tokenizer front door.  Returns the one-token run's decode
    tokens/s."""
    import torch

    from theanompi_tpu_torch.models import LLAMA3_8B, Llama
    from theanompi_tpu_torch.obs import span_tree, write_chrome_trace
    from theanompi_tpu_torch.serving import (
        ByteTokenizer,
        Engine,
        PagedLlamaDecoder,
        handoff_bytes,
    )
    from theanompi_tpu_torch.ops.norm import rms_norm_cuda
    from theanompi_tpu_torch.serving.paged_attention import paged_attend_cuda

    card = card_line()
    cfg = dict(LLAMA3_8B, compute_dtype="bfloat16", seed=0,
               n_layers=n_layers or EXT_LAYERS)
    t0 = time.perf_counter()
    model = Llama(cfg, device=dev)
    model.params
    torch.cuda.synchronize()
    log(f"[serving_ext] model: {cfg['n_layers']} layers at Llama-3-8B "
        f"width, bf16, random init in {time.perf_counter() - t0:.1f} s")
    prompts, shared = make_requests(model.vocab)
    reqs = shared[:1] + prompts + shared[1:]
    kw = dict(max_slots=8, max_seq=2048, block_size=16, prefill_chunk=64)
    dec = PagedLlamaDecoder(model, **kw)
    rows = SPEC_K * dec._rep
    ext_run(dec, [prompts[0][:40]], max_tokens=8)                # warm-up
    ext_run(dec, [prompts[0][:40]], max_tokens=8, speculate_k=SPEC_K)

    out = {}
    per_call = norm_launches_per_call(model)
    # one-token decode, then speculation, each counted alone
    reset_counts(paged_attend_cuda, rms_norm_cuda)
    decodes, prefills = Calls(dec, "decode"), Count(dec, "prefill")
    plain, peng, plain_wall = ext_run(dec, reqs)
    decodes.undo()
    prefills.undo()
    plain_launches = paged_attend_cuda.launches
    norm_plain = rms_norm_cuda.launches
    want_plain = per_call * (decodes.n + prefills.n)
    reset_counts(paged_attend_cuda, rms_norm_cuda)
    verifies, prefills = Calls(dec, "verify"), Count(dec, "prefill")
    spec, seng, spec_wall = ext_run(dec, reqs, speculate_k=SPEC_K)
    verifies.undo()
    prefills.undo()
    norm_spec = rms_norm_cuda.launches
    want_spec = per_call * (verifies.n + prefills.n)
    launches = paged_attend_cuda.launches
    by_rows = dict(paged_attend_cuda.launches_by_rows)
    tc = paged_attend_cuda.tc_launches
    ps, ss = peng.recorder.summary(), seng.recorder.summary()
    plain_ids = [r.tokens for r in plain]
    spec_ids = [r.tokens for r in spec]
    same = sum(a == b for a, b in zip(plain_ids, spec_ids))
    div = first_divergence(plain_ids, spec_ids)
    out["speculation"] = {
        "speculate_k": SPEC_K, "k4_rows": rows,
        "decode_tokens_per_s": {"one_token": ps["tokens_per_sec"],
                                "speculative": ss["tokens_per_sec"]},
        "decode_s": {"one_token": ps["decode_s"],
                     "speculative": ss["decode_s"]},
        "accept_rate": ss["accept_rate"],
        "tokens_per_step": ss["tokens_per_step"],
        "drafted": ss["drafted_tokens"], "accepted": ss["accepted_tokens"],
        "median_step_ms": {
            "decode": statistics.median(
                st["dt_s"] for st in peng.recorder.steps) * 1e3,
            "verify": statistics.median(
                st["dt_s"] for st in seng.recorder.steps) * 1e3},
        "median_call_ms": {"decode": statistics.median(decodes.ms),
                           "verify": statistics.median(verifies.ms)},
        "calls": {"decode": decodes.n, "verify": verifies.n},
        "k4_launches": {"one_token": plain_launches, "speculative": launches,
                        "speculative_by_rows": by_rows,
                        "speculative_tensor_cores": tc},
        "rms_norm_launches": {"one_token": norm_plain,
                              "speculative": norm_spec},
        "requests_equal": f"{same} of {len(reqs)}",
        "first_divergence": div,
        "wall_s": {"one_token": plain_wall, "speculative": spec_wall},
        "wall_ratio": spec_wall / plain_wall,
        "finish_reasons": ss["finish_reasons"],
    }
    log(f"[serving_ext speculation] {json.dumps(out['speculation'])} "
        f"on {card}")
    if launches != dec.model.n_layers * verifies.n or tc != launches \
            or by_rows != {16: launches} or rows != 16:
        raise AssertionError(
            f"serving_ext: K4 launches {launches} (tensor cores {tc}, by "
            f"rows {by_rows}), want {dec.model.n_layers} x {verifies.n} "
            f"verify steps, all on the tensor cores at 16 rows")
    if not (ss["accept_rate"] and ss["accept_rate"] > 0
            and ss["tokens_per_step"] > 1):
        raise AssertionError(f"serving_ext: speculation accepted nothing "
                             f"({ss['accept_rate']}, "
                             f"{ss['tokens_per_step']})")
    if (norm_plain, norm_spec) != (want_plain, want_spec):
        raise AssertionError(
            f"serving_ext: rms_norm launches {norm_plain} / {norm_spec}, "
            f"want {per_call} a decoder call: {want_plain} / {want_spec}")
    # every serving norm is row-count independent on the card, so a
    # verify row rounds as the decode row does: speculative ids equal
    # one-token decode's, asserted; on a miss the diagnostics name what
    # differs before the phase fails
    causes = equality_causes(dec)
    if div is not None:
        r = div[0]
        causes["request"] = r
        causes["alone"] = replay_alone(dec, reqs[r], 32)
        causes["first_window"] = first_window(dec, reqs[r])
    out["equality"] = causes
    log(f"[serving_ext equality] {same} of {len(reqs)} requests equal; "
        f"{json.dumps(causes)} on {card}")
    if same != len(reqs):
        raise AssertionError(
            f"serving_ext: speculative ids differ from one-token decode's "
            f"in {len(reqs) - same} of {len(reqs)} requests (first at "
            f"{div})")
    out["speculation_k8"] = run_spec_wide(dec, reqs, plain_ids, per_call,
                                          card)
    out["norm_ab"] = profile_norm_ab(dec, prompts)
    out["profile_verify"] = profile_decode("serving_ext verify", dec,
                                           prompts, speculate_k=SPEC_K)

    # disaggregated: prefill on A, decode from the handoffs on B (= dec)
    dec_a = PagedLlamaDecoder(model, **kw)
    exports = Calls(dec_a, "export_blocks")
    imports = Calls(dec, "import_blocks")
    ext_run(dec_a, [prompts[0][:40]], max_tokens=8, prefill_only=True)
    exports.ms.clear()
    pre, _, pre_wall = ext_run(dec_a, reqs, prefill_only=True)
    handoffs = [r.handoff for r in pre]
    dis, _, dis_wall = ext_run(dec, reqs, handoffs=handoffs)
    exports.undo()
    imports.undo()
    dis_ids = [r.tokens for r in dis]
    nbytes = [handoff_bytes(h) for h in handoffs]
    n_same = sum(a == b for a, b in zip(dis_ids, plain_ids))
    out["disaggregated"] = {
        "requests_equal_unified": f"{n_same} of {len(reqs)}",
        "handoff_bytes": nbytes,
        "prompt_tokens": [len(p) for p in reqs],
        "export_ms": exports.ms, "import_ms": imports.ms,
        "export_gb_per_s": sum(nbytes) / sum(exports.ms) / 1e6,
        "import_gb_per_s": sum(nbytes) / sum(imports.ms) / 1e6,
        "prefill_wall_s": pre_wall, "decode_wall_s": dis_wall,
    }
    log(f"[serving_ext disaggregated] {json.dumps(out['disaggregated'])} "
        f"on {card}")
    if dis_ids != plain_ids:
        raise AssertionError(f"serving_ext: disaggregated ids differ from "
                             f"unified ones at "
                             f"{first_divergence(plain_ids, dis_ids)}")
    del dec_a, pre, handoffs
    torch.cuda.empty_cache()

    # tracing off / on, then the tokenizer front door
    rates, spans_per_req, traced_eng = {"off": [], "on": []}, [], None
    for mode in ("off", "on"):
        ekw = dict(trace_sample=1) if mode == "on" else {}
        rs, eng, _ = ext_run(dec, reqs, **ekw)
        rates[mode].append(eng.recorder.summary()["tokens_per_sec"])
        if [r.tokens for r in rs] != plain_ids:
            raise AssertionError(f"serving_ext: tracing {mode} changed ids")
        if mode == "on":
            traced_eng, traced = eng, rs
    trees = [span_tree(r.spans, r.spans[0]["trace_id"]) for r in traced]
    path = write_chrome_trace(
        traced_eng.tracer.spans(), ROOT / "build" / "serving_ext_trace.json",
        counters=traced_eng.recorder.counter_tracks())
    out["tracing"] = {
        "decode_tokens_per_s": rates,
        "spans_per_request": [t["n_spans"] for t in trees],
        "connected": all(t["connected"] for t in trees),
        "chrome_trace": str(Path(path).relative_to(ROOT)),
    }
    log(f"[serving_ext tracing] {json.dumps(out['tracing'])} on {card}")
    if not out["tracing"]["connected"] or any(
            t["root_name"] != "request" for t in trees):
        raise AssertionError(f"serving_ext: span trees broken: {trees}")
    tok = ByteTokenizer()
    texts = ["The quick brown fox", "jumps over the lazy dog, again.",
             "speculative decoding on the H100"]
    eng = Engine(dec, prefix_caching=False, tokenizer=tok)
    try:
        by_text = [eng.submit_text(x, max_tokens=8, seed=i)
                   for i, x in enumerate(texts)]
        by_ids = [eng.submit(tok.encode(x), max_tokens=8, seed=i)
                  for i, x in enumerate(texts)]
        eng.run_until_idle()
    finally:
        eng.stop()
    a = [f.result(timeout=0).tokens for f in by_text]
    b = [f.result(timeout=0).tokens for f in by_ids]
    summ = eng.recorder.summary()
    log(f"[serving_ext tokenizer] submit_text vs submit(encode) ids: "
        f"{'equal' if a == b else 'DIFFER'}; tokenize items "
        f"{summ['tokenize_items']}, items per sweep "
        f"{summ['tokenize_items_per_sweep']}")
    if a != b or not all(len(x) == 8 for x in a):
        raise AssertionError("serving_ext: submit_text ids differ")
    del dec, model
    torch.cuda.empty_cache()
    if "K4" in records:
        rec = records["K4"]
        by_path = rec.setdefault("launches_by_path", {})
        by_path["serving_ext_decode"] = plain_launches
        by_path["serving_ext_verify"] = launches
        by_path["serving_ext_verify_k8"] = \
            out["speculation_k8"]["k4_launches"]
        rec["launches"] = sum(by_path.values())
        rec["verify_shape"]["launches"] = launches
    if "rms_norm" in records:
        add_launches(records["rms_norm"], serving_ext_decode=norm_plain,
                     serving_ext_verify=norm_spec,
                     serving_ext_verify_k8=out["speculation_k8"][
                         "rms_norm_launches"])
    log(f"[serving_ext] " + json.dumps({
        k: out["speculation"][k] for k in ("decode_tokens_per_s",
                                           "accept_rate", "tokens_per_step",
                                           "median_step_ms", "wall_ratio")})
        + f" on {card}")
    return out["speculation"]["decode_tokens_per_s"]["one_token"]


def run_spec_wide(dec, reqs, plain_ids, per_call, card) -> dict:
    """``speculate_k = SPEC_K_WIDE`` off the serving_ext decoder: 32 K4
    rows at rep 4, two row groups.  K4's launches by row count (all at
    32, layers x verify steps, asserted) and the norm's; the ids equal
    one-token decode's (asserted: the decoder runs every decode and
    verify product at its one row count, ``product_rows``), with the
    first divergence and ``equality_causes`` at this window printed
    first on a miss."""
    import torch

    from theanompi_tpu_torch.ops.norm import rms_norm_cuda
    from theanompi_tpu_torch.serving.paged_attention import paged_attend_cuda

    rows = SPEC_K_WIDE * dec._rep
    reset_counts(paged_attend_cuda, rms_norm_cuda)
    verifies, prefills = Calls(dec, "verify"), Count(dec, "prefill")
    spec, eng, wall = ext_run(dec, reqs, speculate_k=SPEC_K_WIDE)
    verifies.undo()
    prefills.undo()
    launches = paged_attend_cuda.launches
    by_rows = dict(paged_attend_cuda.launches_by_rows)
    norms = rms_norm_cuda.launches
    ids = [r.tokens for r in spec]
    same = sum(a == b for a, b in zip(plain_ids, ids))
    div = first_divergence(plain_ids, ids)
    summ = eng.recorder.summary()
    out = {
        "speculate_k": SPEC_K_WIDE, "k4_rows": rows,
        "k4_launches": launches, "k4_launches_by_rows": by_rows,
        "rms_norm_launches": norms,
        "decode_tokens_per_s": summ["tokens_per_sec"],
        "accept_rate": summ["accept_rate"],
        "tokens_per_step": summ["tokens_per_step"],
        "median_call_ms": statistics.median(verifies.ms),
        "calls": verifies.n, "wall_s": wall,
        "requests_equal": f"{same} of {len(reqs)}",
        "first_divergence": div,
    }
    if div is not None:        # (its checks launch kernels: counted above)
        out["equality_causes"] = equality_causes(dec, SPEC_K_WIDE)
    log(f"[serving_ext speculation k={SPEC_K_WIDE}] {json.dumps(out)} on "
        f"{card}")
    want_norm = per_call * (verifies.n + prefills.n)
    if launches != dec.model.n_layers * verifies.n \
            or by_rows != {rows: launches} or rows != 32 \
            or norms != want_norm:
        raise AssertionError(
            f"serving_ext k={SPEC_K_WIDE}: K4 launches {by_rows}, want "
            f"{dec.model.n_layers} x {verifies.n} at 32 rows; norms "
            f"{norms}, want {want_norm}")
    if same != len(reqs):
        raise AssertionError(
            f"serving_ext k={SPEC_K_WIDE}: speculative ids differ from "
            f"one-token decode's in {len(reqs) - same} of {len(reqs)} "
            f"requests (first at {div})")
    torch.cuda.empty_cache()
    return out


# -- serving_fleet: the router, the replicas, the autoscaler -----------------

FLEET_KW = dict(max_slots=8, max_seq=2048, block_size=16, prefill_chunk=64)
FLEET_TOKENS = 32
FLEET_DRILL = "1:2:die_replica"   # replica 1 dies at its 2nd busy step
FLEET_TCP_LAYERS = 2              # the TCP child's depth (REDUCED)
FLEET_RESULT_TIMEOUT_S = 600.0


class FleetCounts:
    """K4 and RMS norm launches over one fleet run, reset at the start,
    with each replica decoder's decode and prefill calls counted on the
    instance (each decoder is stepped by one replica thread).  ``close``
    checks K4 = layers x decode calls and norms = (2 layers + 1) x
    (decode + prefill calls), summed over the replicas in this
    process."""

    def __init__(self, decoders=()):
        from theanompi_tpu_torch.ops.norm import rms_norm_cuda
        from theanompi_tpu_torch.serving.paged_attention import (
            paged_attend_cuda,
        )

        self.k4, self.norm = paged_attend_cuda, rms_norm_cuda
        reset_counts(self.k4, self.norm)
        self.calls = []
        for d in decoders:
            self.add(d)

    def add(self, dec) -> None:
        self.calls.append((dec, Count(dec, "decode"), Count(dec, "prefill")))

    def close(self, name: str) -> dict:
        import torch

        for _, dc, pc in self.calls:
            dc.undo()
            pc.undo()
        layers = self.calls[0][0].model.n_layers
        decode = sum(dc.n for _, dc, _ in self.calls)
        prefill = sum(pc.n for _, _, pc in self.calls)
        out = {"k4_launches": self.k4.launches,
               "k4_tensor_cores": self.k4.tc_launches,
               "k4_tf32x3": self.k4.tf32x3_launches,
               "rms_norm_launches": self.norm.launches,
               "decode_calls_by_replica": [dc.n for _, dc, _ in self.calls],
               "prefill_calls_by_replica": [pc.n for _, _, pc in self.calls]}
        want = (layers * decode, (2 * layers + 1) * (decode + prefill))
        # bf16 takes K4's bf16 tensor-core kernel, fp32 its three-pass
        # TF32 one
        bf16 = self.calls[0][0].model.compute_dtype == torch.bfloat16
        n = out["k4_launches"]
        if (n, out["rms_norm_launches"]) != want \
                or out["k4_tensor_cores"] != (n if bf16 else 0) \
                or out["k4_tf32x3"] != (0 if bf16 else n):
            raise AssertionError(
                f"serving_fleet {name}: K4 {n} (bf16 tensor cores "
                f"{out['k4_tensor_cores']}, three-pass TF32 "
                f"{out['k4_tf32x3']}), rms_norm "
                f"{out['rms_norm_launches']}; want {want[0]} = {layers} x "
                f"{decode} decode calls, {want[1]} = {2 * layers + 1} x "
                f"{decode + prefill} decoder calls")
        return out


def start_fleet(decoders, *, roles=None, engine_kw=None, **router_kw):
    """One started ``InProcessReplica`` a decoder (a fresh ``Engine``
    each, prefix caching off unless ``engine_kw`` says otherwise) behind
    a started ``Router``."""
    from theanompi_tpu_torch.serving import Engine, InProcessReplica, Router

    ekw = {"prefix_caching": False, **(engine_kw or {})}
    reps = [InProcessReplica(Engine(d, **ekw), name=f"r{i}", index=i,
                             role=(roles or {}).get(i, "unified")).start()
            for i, d in enumerate(decoders)]
    router_kw.setdefault("policy", "round_robin")
    return Router(reps, health_interval_s=0.01, startup_grace_s=600.0,
                  **router_kw).start(), reps


def stop_fleet(router, reps) -> None:
    """Stop the router and every replica loop, then free what a dead
    loop left in its engine (slots and blocks), so the decoders serve
    on."""
    router.stop(drain_s=5.0)
    for r in reps:
        r.stop()
        r.engine.abandon_all()


def fleet_submit(router, reqs, idx=None, max_tokens=FLEET_TOKENS):
    """Submit ``reqs`` (request i with seed ``idx[i]``, default i)."""
    idx = list(range(len(reqs))) if idx is None else idx
    return [router.submit(p, max_tokens=max_tokens, seed=int(i))
            for p, i in zip(reqs, idx)]


def fleet_results(name, futs, vocab, max_tokens=FLEET_TOKENS):
    """Every future's result (each must resolve ``ok`` with
    ``max_tokens`` ids in the vocab within the timeout)."""
    out = []
    for i, f in enumerate(futs):
        r = f.result(timeout=FLEET_RESULT_TIMEOUT_S)
        if r.status != "ok" or len(r.tokens) != max_tokens or not all(
                0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"serving_fleet {name}: request {i} "
                                 f"{r.status}/{r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        out.append(r)
    return out


def fleet_line(name, router, wall, counts=None, **extra) -> dict:
    """The arm's fleet numbers (``FleetRecorder``): aggregate decode
    tokens/s, TTFT/TPOT p50/p95, requests dispatched per replica, the
    failover counters, and the kernel counts."""
    summ = router.fleet_summary()
    line = {"arm": name, "wall_s": wall,
            "aggregate_decode_tokens_per_s":
                summ["aggregate_tokens_per_sec"],
            **{k: summ[k] for k in (
                "ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
                "dispatched", "n_completed", "tokens_completed",
                "n_requeues", "n_failovers", "n_handoffs",
                "prefix_hit_rate")},
            **(counts or {}), **extra}
    log(f"[serving_fleet {name}] {json.dumps(line)} on {card_line()}")
    return summ, line


def run_arm(name, decoders, reqs, vocab, *, roles=None, engine_kw=None,
            **router_kw):
    """Serve ``reqs`` through a fresh fleet over ``decoders``; returns
    (results, fleet summary, the arm's line)."""
    import torch

    counts = FleetCounts(decoders)
    router, reps = start_fleet(decoders, roles=roles, engine_kw=engine_kw,
                               **router_kw)
    try:
        t0 = time.perf_counter()
        rs = fleet_results(name, fleet_submit(router, reqs), vocab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ, line = fleet_line(name, router, wall, counts.close(name))
    finally:
        stop_fleet(router, reps)
    return rs, summ, line


def profile_fleet(decoders, prompts, steps: int = 4) -> dict:
    """The three-replica fleet of the drill, before any kill: every
    engine's 8 slots filled (prompts cut to 512 tokens) and prefilled
    inline, then the replica loops started and traced under
    ``torch.profiler`` until each replica has taken ``steps`` more
    decode steps: device time by kind and the top kernels over the
    window's wall time (the busy share), decode steps in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.serving import Engine, InProcessReplica

    engines = [Engine(d, prefix_caching=False) for d in decoders]
    for e in engines:
        for j, p in enumerate(prompts[:e.decoder.max_slots]):
            e.submit(p[:512], max_tokens=e.decoder.max_seq, seed=j)
        e.step()
        while e.n_prefilling():
            e.step()
    reps = [InProcessReplica(e, name=f"r{i}", index=i)
            for i, e in enumerate(engines)]

    def progress():
        return [r.heartbeat()["progress"] for r in reps]

    def wait_steps(base, n):
        deadline = time.monotonic() + 300.0
        while min(p - b for p, b in zip(progress(), base)) < n:
            if time.monotonic() > deadline:
                raise AssertionError("serving_fleet profile: replicas "
                                     "stopped stepping")
            time.sleep(0.001)

    try:
        for r in reps:
            r.start()
        wait_steps([0] * len(reps), 2)             # warm, all decoding
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            base, t0 = progress(), time.perf_counter()
            wait_steps(base, steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            took = [p - b for p, b in zip(progress(), base)]
    finally:
        for r in reps:
            r.stop()
            r.engine.abandon_all()
    kernels = device_kernels(prof)
    dev_ms = sum(ms for _, ms in kernels)
    by_kind = {}
    for k, ms in kernels:
        by_kind[kernel_kind(k)] = by_kind.get(kernel_kind(k), 0.0) + ms
    out = {"replicas": len(reps), "decode_steps": took,
           "window_wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms,
           "device_ms_per_decode_step": dev_ms / sum(took),
           "wall_ms_per_fleet_step": wall_ms / (sum(took) / len(reps)),
           "device_ms_by_kind": by_kind,
           "top_kernels_ms": {k[:80]: ms for k, ms in kernels[:6]}}
    log(f"[serving_fleet profile] three replicas before the kill: "
        f"{json.dumps(out)} on {card_line()}")
    return out


def fleet_drill(decoders, reqs, vocab):
    """The kill-one-of-three drill: ``TM_FAULT_AT=FLEET_DRILL`` kills
    replica 1's loop at its 2nd busy step; returns (results, summary,
    line, whether replica 1 died of the drill).  On the card the kernel
    launches are counted and checked (``FleetCounts``)."""
    import torch

    from theanompi_tpu_torch.utils import faults

    on_card = decoders[0].device.type == "cuda"
    counts = FleetCounts(decoders) if on_card else None
    faults.reset_fault_cache()
    os.environ["TM_FAULT_AT"] = FLEET_DRILL
    try:
        router, reps = start_fleet(decoders)
        try:
            t0 = time.perf_counter()
            rs = fleet_results("drill", fleet_submit(router, reqs), vocab)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            died = reps[1].dead and "ReplicaDied" in (reps[1].death_cause
                                                      or "")
            summ, line = fleet_line(
                "drill", router, wall,
                counts.close("drill") if on_card else None,
                device=decoders[0].device.type)
        finally:
            stop_fleet(router, reps)
    finally:
        del os.environ["TM_FAULT_AT"]
        faults.reset_fault_cache()
    return rs, summ, line, died


def check_fleet_drill(name, rs, summ, died, ref_ids) -> None:
    ids = [r.tokens for r in rs]
    problems = []
    if summ["n_completed"] != len(rs):
        problems.append(f"{summ['n_completed']} completed")
    if summ["n_requeues"] < 1 or summ["n_failovers"] < 1:
        problems.append(f"requeues {summ['n_requeues']}, failovers "
                        f"{summ['n_failovers']}")
    if summ["members"]["r1"]["healthy"] is not False or not died:
        problems.append(f"r1 {summ['members']['r1']}, died {died}")
    same = sum(a == b for a, b in zip(ids, ref_ids))
    log(f"[serving_fleet {name}] drill ids equal to one replica's: "
        f"{same} of {len(ids)}")
    if same != len(ids):
        problems.append(f"ids differ at {first_divergence(ref_ids, ids)}")
    if problems:
        raise AssertionError(f"serving_fleet {name}: " + "; ".join(problems))


def check_fleet_reference(dev) -> None:
    """The drill on the small fp32 model, on the card and on the CPU from
    one set of weights: ids equal across the devices and to one
    replica's."""
    from theanompi_tpu_torch.serving import PagedLlamaDecoder

    gpu, cpu = small_pair(dev)
    prompts = small_ext_prompts(SMALL["vocab"]) * 2
    kw = dict(max_slots=4, max_seq=128, block_size=16, prefill_chunk=32)
    ids = {}
    for name, m in (("card", gpu), ("cpu", cpu)):
        decs = [PagedLlamaDecoder(m, **kw) for _ in range(3)]
        router, reps = start_fleet(decs[:1])
        try:
            ref = [r.tokens for r in fleet_results(
                f"reference {name}", fleet_submit(router, prompts),
                SMALL["vocab"])]
        finally:
            stop_fleet(router, reps)
        rs, summ, _, died = fleet_drill(decs, prompts, SMALL["vocab"])
        check_fleet_drill(f"reference {name}", rs, summ, died, ref)
        ids[name] = ref
    log(f"reference [serving_fleet] small fp32 model, kill-one-of-three "
        f"drill, card vs CPU ids: "
        f"{'equal' if ids['card'] == ids['cpu'] else 'DIFFER'}")
    if ids["card"] != ids["cpu"]:
        raise AssertionError("serving_fleet: card and CPU drill ids differ")


def start_replica_child(spec: dict):
    """``python -m theanompi_tpu_torch.serving.replica --spec-json`` in
    a child process; returns (process, port) once it prints
    ``REPLICA_READY``."""
    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.serving.replica",
         "--spec-json", json.dumps(spec)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    seen, deadline = [], time.monotonic() + DIST_CHILD_TIMEOUT_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            continue
        if line is None:
            break
        seen.append(line)
        if line.startswith("REPLICA_READY"):
            return proc, int(line.split()[1])
    proc.kill()
    proc.wait()
    raise AssertionError("serving_fleet: the replica child never became "
                         "ready:\n" + "".join(seen[-40:]))


def fleet_tcp_arm(dev, cfg, reqs) -> dict:
    """A ``ReplicaServer`` child at full width, ``FLEET_TCP_LAYERS``
    deep, restored from a checkpoint this process writes, beside an
    in-process member over the same weights; the child is killed with
    SIGKILL mid-stream.  Every future must resolve and the failover be
    recorded."""
    import signal

    import torch

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.models.llama import params_to_jax
    from theanompi_tpu_torch.serving import (
        Engine,
        InProcessReplica,
        PagedLlamaDecoder,
        Router,
        TCPReplicaClient,
    )
    from theanompi_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = dict(cfg, n_layers=FLEET_TCP_LAYERS)
    model = Llama(cfg, device=dev)
    ckpt = ROOT / "build" / "serving_fleet_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    path = save_checkpoint(ckpt, 0, {"params": params_to_jax(model.params)})
    write_s = time.perf_counter() - t0
    dec = PagedLlamaDecoder(model, **FLEET_KW)
    ext_run(dec, [reqs[0][:40]], max_tokens=4)                  # warm-up
    spec = dict(config=cfg, checkpoint=str(ckpt), device=str(dev),
                paged=True, decoder=FLEET_KW,
                engine={"prefix_caching": False}, name="tcp0", index=0)
    t0 = time.perf_counter()
    proc, port = start_replica_child(spec)
    ready_s = time.perf_counter() - t0
    client = local = router = None
    try:
        client = TCPReplicaClient(("127.0.0.1", port), name="tcp0",
                                  ping_interval_s=0.05, slots=8)
        local = InProcessReplica(Engine(dec, prefix_caching=False),
                                 name="local1", index=1).start()
        router = Router([client, local], policy="round_robin",
                        health_interval_s=0.01, startup_grace_s=600.0
                        ).start()
        counts = FleetCounts([dec])
        t0 = time.perf_counter()
        futs = fleet_submit(router, reqs)
        deadline = time.monotonic() + 300.0
        while client.heartbeat()["progress"] < 4:
            if time.monotonic() > deadline or client.dead:
                raise AssertionError("serving_fleet tcp: the child never "
                                     "stepped")
            time.sleep(0.005)
        os.kill(proc.pid, signal.SIGKILL)
        killed_at = client.heartbeat()["progress"]
        rs = fleet_results("tcp", futs, model.vocab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ, line = fleet_line(
            "tcp", router, wall, counts.close("tcp"),
            checkpoint_gb=path.stat().st_size / 1e9,
            checkpoint_write_s=write_s, child_ready_s=ready_s,
            killed_at_child_step=killed_at)
        if summ["n_failovers"] < 1 or summ["n_requeues"] < 1 \
                or summ["members"]["tcp0"]["healthy"] is not False:
            raise AssertionError(f"serving_fleet tcp: the kill was not "
                                 f"failed over: {summ['members']}, "
                                 f"{summ['n_failovers']} failovers, "
                                 f"{summ['n_requeues']} requeues")
    finally:
        if router is not None:
            router.stop(drain_s=5.0)
        if local is not None:
            local.stop()
            local.engine.abandon_all()
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)
    del dec, model
    torch.cuda.empty_cache()
    return line


def fleet_autoscale_arm(model, first_dec, reqs) -> dict:
    """``Autoscaler(min_replicas=1, max_replicas=2)`` over a one-replica
    fleet, its spawn factory building a decoder over the shared model: a
    flood of twice the requests scales it to two replicas, and idle it
    drains back to one.  Exact token accounting; replica-seconds."""
    import torch

    from theanompi_tpu_torch.serving import (
        Autoscaler,
        Engine,
        PagedLlamaDecoder,
        InProcessReplica,
    )

    flood = reqs * 2
    counts = FleetCounts([first_dec])
    # a replica queues at most its slots: the rest waits at the router,
    # where a new member can take it
    router, reps = start_fleet([first_dec], policy="least_loaded",
                               replica_queue_cap=FLEET_KW["max_slots"])
    spawned = []

    def spawn(i):
        dec = PagedLlamaDecoder(model, **FLEET_KW)
        counts.add(dec)
        rep = InProcessReplica(Engine(dec, prefix_caching=False),
                               name=f"r{i}", index=i).start()
        spawned.append(rep)
        return rep

    def retire(rep):
        rep.stop()
        rep.engine.abandon_all()

    asc = Autoscaler(router, spawn, retire=retire, min_replicas=1,
                     max_replicas=2, scale_up_at=1.5, scale_down_at=0.25,
                     up_hold_s=0.2, down_hold_s=1.0, cooldown_s=0.5,
                     interval_s=0.05).start()
    try:
        t0 = time.perf_counter()
        rs = fleet_results("autoscale", fleet_submit(router, flood),
                           model.vocab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 120.0
        while len(router.members()) > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        asc.stop()
        a = asc.summary()
        summ, line = fleet_line(
            "autoscale", router, wall, counts.close("autoscale"),
            replica_seconds=router.recorder.replica_seconds(),
            scale_events=[{k: e[k] for k in ("event", "replica", "reason")}
                          for e in a["events"]],
            members_after=sorted(router.members()))
    finally:
        asc.stop()
        stop_fleet(router, reps + spawned)
    tokens = sum(len(r.tokens) for r in rs)
    want = len(flood) * FLEET_TOKENS
    if tokens != want or summ["tokens_completed"] != want \
            or summ["n_completed"] != len(flood) or a["dead"] \
            or (a["n_scale_ups"], a["n_scale_downs"]) != (1, 1) \
            or (summ["n_spawns"], summ["n_retires"]) != (2, 1) \
            or len(line["members_after"]) != 1 \
            or len(summ["dispatched"]) != 2:
        raise AssertionError(
            f"serving_fleet autoscale: {tokens} tokens (want {want}), "
            f"{summ['n_completed']} completed, autoscaler {a}")
    del spawned
    torch.cuda.empty_cache()
    return line


def run_serving_fleet(dev, n_layers: int | None, records: dict,
                      one_engine_tokens_per_s=None) -> None:
    """Phase serving_fleet at Llama-3-8B width, bf16, ``n_layers`` deep
    (the serving phase's model and requests, prefix caching off unless
    said): one replica behind the router (the reference ids), the
    kill-one-of-three drill (after a profile of the three replicas),
    prefix affinity against round robin, disaggregated prefill/decode,
    a TCP replica child killed mid-stream, and the autoscaler."""
    import torch

    from theanompi_tpu_torch.models import LLAMA3_8B, Llama
    from theanompi_tpu_torch.serving import PagedLlamaDecoder

    card = card_line()
    cfg = dict(LLAMA3_8B, compute_dtype="bfloat16", seed=0,
               n_layers=n_layers or FLEET_LAYERS)
    model = Llama(cfg, device=dev)
    model.params
    prompts, shared = make_requests(model.vocab)
    reqs = shared[:1] + prompts + shared[1:]
    decs = [PagedLlamaDecoder(model, **FLEET_KW) for _ in range(3)]
    log(f"[serving_fleet] model: {cfg['n_layers']} layers at Llama-3-8B "
        f"width, bf16; 3 decoders over one model, pools "
        f"{3 * decs[0].kv_cache_bytes() / 2**30:.2f} GiB; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    for d in decs:                                      # warm-up
        ext_run(d, [prompts[0][:40]], max_tokens=4)
    lines = {}

    # 1: one replica behind the router: the reference ids
    rs, _, lines["one"] = run_arm("one replica", decs[:1], reqs, model.vocab)
    ref = [r.tokens for r in rs]

    # 2: the drill, after a profile of the three replicas before it
    lines["profile"] = profile_fleet(decs, prompts)
    rs, summ, lines["drill"], died = fleet_drill(decs, reqs, model.vocab)
    check_fleet_drill("drill", rs, summ, died, ref)
    if one_engine_tokens_per_s:
        lines["drill"]["vs_serving_ext_one_token"] = (
            lines["drill"]["aggregate_decode_tokens_per_s"]
            / one_engine_tokens_per_s)
    lines["drill"]["vs_one_replica"] = (
        lines["drill"]["aggregate_decode_tokens_per_s"]
        / lines["one"]["aggregate_decode_tokens_per_s"])

    # 3: prefix affinity against round robin, prefix caching on; the
    # system-prompt requests after the first of them was served, keyed
    # on a block the size of the system prompt
    order = [0] + list(range(1, 13)) + [13, 14, 15]
    for policy in ("round_robin", "prefix_affinity"):
        counts = FleetCounts(decs)
        router, reps = start_fleet(decs, engine_kw={"prefix_caching": True},
                                   policy=policy, affinity_block=256)
        try:
            t0 = time.perf_counter()
            first = fleet_submit(router, [reqs[i] for i in order[:13]],
                                 order[:13])
            first[0].result(timeout=FLEET_RESULT_TIMEOUT_S)
            rest = fleet_submit(router, [reqs[i] for i in order[13:]],
                                order[13:])
            rs = fleet_results(policy, first + rest, model.vocab)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ids = {i: r.tokens for i, r in zip(order, rs)}
            _, lines[policy] = fleet_line(
                policy, router, wall, counts.close(policy),
                ids_equal_one_replica=sum(ids[i] == ref[i] for i in order))
        finally:
            stop_fleet(router, reps)
            for d in decs:
                d.prefix_cache.clear()

    # 4: disaggregated prefill/decode: prefill on r0, decode on r1
    handoff = {"export_ms": [], "kv_bytes": []}
    export = decs[0].export_blocks

    def timed_export(block_ids):        # its D2H copy fences it
        t0 = time.perf_counter()
        layers = export(block_ids)
        handoff["export_ms"].append((time.perf_counter() - t0) * 1e3)
        handoff["kv_bytes"].append(
            sum(x["k"].nbytes + x["v"].nbytes for x in layers))
        return layers

    decs[0].export_blocks = timed_export
    imports = Calls(decs[1], "import_blocks")
    try:
        rs, summ, lines["disaggregated"] = run_arm(
            "disaggregated", decs[:2], reqs, model.vocab,
            roles={0: "prefill", 1: "decode"})
    finally:
        del decs[0].export_blocks
        imports.undo()
    same = sum(r.tokens == x for r, x in zip(rs, ref))
    handoff.update(import_ms=imports.ms,
                   export_ms_median=statistics.median(handoff["export_ms"]),
                   import_ms_median=statistics.median(imports.ms),
                   ids_equal_one_replica=f"{same} of {len(reqs)}")
    lines["disaggregated"].update(handoff)
    log(f"[serving_fleet disaggregated handoffs] {json.dumps(handoff)}")
    if same != len(reqs) or summ["n_handoffs"] != len(reqs):
        raise AssertionError(f"serving_fleet disaggregated: {same} of "
                             f"{len(reqs)} ids equal, "
                             f"{summ['n_handoffs']} handoffs")

    # 6 (before 5, which needs the card's memory for its own model):
    # the autoscaler over the shared model
    lines["autoscale"] = fleet_autoscale_arm(model, decs[0], reqs)
    del decs
    torch.cuda.empty_cache()

    # 5: a TCP replica child killed mid-stream
    lines["tcp"] = fleet_tcp_arm(dev, cfg, reqs)
    del model
    torch.cuda.empty_cache()

    k4 = sum(line.get("k4_launches", 0) for line in lines.values())
    norms = sum(line.get("rms_norm_launches", 0) for line in lines.values())
    if "K4" in records:
        add_launches(records["K4"], serving_fleet=k4)
    if "rms_norm" in records:
        add_launches(records["rms_norm"], serving_fleet=norms)
    log(f"[serving_fleet] " + json.dumps({
        a: {k: lines[a].get(k) for k in (
            "aggregate_decode_tokens_per_s", "ttft_p50_s", "tpot_p50_s",
            "busy_share", "prefix_hit_rate", "vs_one_replica",
            "vs_serving_ext_one_token")}
        for a in lines}) + f" on {card}")


# -- serving_tp: tensor-parallel serving, two ranks on card 0 -----------------

TP = 2
TP_LAYERS = 2          # depth of the serving_tp models (REDUCED)
TP_V1_KW = dict(max_slots=8, max_seq=2048)
TP_TEMP = 0.8
# the bf16 first decode step's logits at tp = 2 against tp = 1 of the
# same weights: each row-parallel product rounds its two partial sums
# to bf16 before their bf16 sum (tp = 1 rounds once, after an fp32
# accumulation), about one bf16 ulp (2**-8 relative) a product, 16
# products over 8 layers; held as relative L2 error over the [8, V]
# logits
TP_LOGITS_RTOL = 5e-2
TP_TCP_REQUESTS = 4
# queue-wait budget of the serving_tp engines: the second wave of
# requests waits for the first, which gloo's host staging slows; the
# budget is not what the phase checks
TP_ENGINE = dict(default_deadline_s=600.0)


def tp_config(dtype: str, n_layers: int, tp: int = 1) -> dict:
    from theanompi_tpu_torch.models import LLAMA3_8B

    return dict(LLAMA3_8B, compute_dtype=dtype, seed=0, n_layers=n_layers,
                tp=tp)


#: the tp = 2 decoder sessions, in the order both ranks run them:
#: (dtype, name, paged, Engine keywords, temperature)
TP_SESSIONS = (
    ("float32", "v1", False, {}, 0.0),
    ("float32", "paged", True, {}, 0.0),
    ("float32", "handoff", True, {}, 0.0),
    ("bfloat16", "paged", True, {}, 0.0),
    ("bfloat16", "sampled", True, {}, TP_TEMP),
    ("bfloat16", "speculative", True, {"speculate_k": SPEC_K}, 0.0),
)


def capture_first_decode(dec, box: list) -> None:
    """Keep (on the host, fp32) the logits of ``dec``'s first decode
    step: its first sampler call on all ``max_slots`` rows."""
    sample = dec._sample

    def hooked(logits, *a, **k):
        if not box and logits.shape[0] == dec.max_slots:
            box.append(logits.float().cpu().numpy())
        return sample(logits, *a, **k)

    dec._sample = hooked


def tp_rank_sessions(dev, group, n_layers: int, before=None,
                     drive=None) -> list | None:
    """Both ranks run this: for each dtype a tp = 2 model of this rank's
    shards (random weights from seed 0: its slices of the tp = 1 draw),
    then each of its ``TP_SESSIONS`` — a fresh decoder that rank 0
    drives (``before(dtype)`` first, then ``drive(dtype, name, dec,
    engine_kw, temperature)``, then ``close``) and rank 1 follows.  Each
    session's K1, K4 and norm launches on this rank, and the bf16
    greedy session's first decode logits, go to rank 0 over the CPU
    group.  Returns [per-rank (counts, logits)] on rank 0, None on rank
    1."""
    import torch
    import torch.distributed as dist

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda
    from theanompi_tpu_torch.ops.norm import rms_norm_cuda
    from theanompi_tpu_torch.serving.paged_attention import paged_attend_cuda

    counts, logits = {}, []
    for dtype in ("float32", "bfloat16"):
        if before is not None:
            before(dtype)
        model = Llama(tp_config(dtype, n_layers, TP), device=dev,
                      group=group)
        model.params
        for dt, name, paged, ekw, temp in TP_SESSIONS:
            if dt != dtype:
                continue
            kw = FLEET_KW if paged else TP_V1_KW
            dec = model.make_decoder(paged=paged, **kw)
            if (dtype, name) == ("bfloat16", "paged"):
                capture_first_decode(dec, logits)
            reset_counts(flash_fwd_cuda, paged_attend_cuda, rms_norm_cuda)
            if group.rank:
                dec.follow()
            else:
                drive(dtype, name, dec, ekw, temp)
                dec.close()
            torch.cuda.synchronize()
            counts[f"{dtype} {name}"] = {
                "K1": flash_fwd_cuda.launches,
                "K4": paged_attend_cuda.launches,
                "K4_route": route_counts(paged_attend_cuda),
                "rms_norm": rms_norm_cuda.launches}
            del dec
        del model
        torch.cuda.empty_cache()
    mine = (counts, logits[0] if logits else None)
    gathered = [None] * group.size if group.rank == 0 else None
    dist.gather_object(mine, gathered, dst=0, group=group.cpu_group)
    return gathered


def serving_tp_follower(dev, init: str, n_layers: int) -> None:
    """Rank 1 of the serving_tp phase (``--tp-rank 1``): join the
    group, follow every session, hand rank 0 its counts, leave."""
    from theanompi_tpu_torch.parallel.mesh import ModelGroup, destroy_group

    group = ModelGroup.join(dev, 1, TP, init, backend="gloo")
    try:
        tp_rank_sessions(dev, group, n_layers)
    finally:
        destroy_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_serving_tp(dev, n_layers: int, records: dict) -> None:
    """Phase serving_tp: tp = 2 serving at Llama-3-8B widths, ``n_layers``
    deep, the two ranks on card 0 over gloo (this process is rank 0 and
    starts rank 1); phase 3's 16 requests at 32 tokens.  fp32: greedy
    ids of ``LlamaDecoder`` and ``PagedLlamaDecoder`` equal tp = 1's of
    the same weights, and a handoff exported at tp = 1 decodes at
    tp = 2 to the same ids (all asserted).  bf16: the first decode
    step's logits within ``TP_LOGITS_RTOL`` of tp = 1's (asserted);
    greedy and sampled ids' agreement with tp = 1 and speculative
    (``speculate_k`` 4) ids' with one-token decode, printed; tokens/s
    and a decode step's device and wall time at tp = 1 and 2.  Each
    rank's K1, K4 and norm launches a session.  Then a tp = 2
    ``ReplicaServer`` child pair (``FLEET_TCP_LAYERS`` deep, fp32) over
    TCP: ``TP_TCP_REQUESTS`` requests with tp = 1's ids."""
    import numpy as np
    import torch

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.parallel.mesh import ModelGroup, destroy_group

    card = card_line()
    init = f"tcp://127.0.0.1:{free_port()}"
    log_path = ROOT / "build" / "serving_tp_rank1.log"
    with open(log_path, "w") as fh:
        follower = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", "1",
             "--tp-init", init, "--layers", str(n_layers)],
            cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT)
    ref, out = {}, {}
    prompts, shared = make_requests(tp_config("float32", 1)["vocab"])
    reqs = shared[:1] + prompts + shared[1:]

    def before(dtype):
        """tp = 1 of the same weights, on this rank, before its
        sessions."""
        from theanompi_tpu_torch.serving import (
            LlamaDecoder,
            PagedLlamaDecoder,
        )

        t0 = time.perf_counter()
        model = Llama(tp_config(dtype, n_layers), device=dev)
        model.params
        ref[dtype] = r = {}
        if dtype == "float32":
            rs, _, _ = ext_run(LlamaDecoder(model, **TP_V1_KW), reqs,
                               **TP_ENGINE)
            r["v1"] = [x.tokens for x in rs]
            dec = PagedLlamaDecoder(model, **FLEET_KW)
            rs, eng, _ = ext_run(dec, reqs, **TP_ENGINE)
            r["paged"] = [x.tokens for x in rs]
            pre, _, _ = ext_run(dec, reqs, prefill_only=True, **TP_ENGINE)
            r["handoffs"] = [x.handoff for x in pre]
        else:
            dec = PagedLlamaDecoder(model, **FLEET_KW)
            box = []
            capture_first_decode(dec, box)
            rs, eng, wall = ext_run(dec, reqs, **TP_ENGINE)
            r["paged"] = [x.tokens for x in rs]
            r["logits"] = box[0]
            r["tokens_per_s"] = eng.recorder.summary()["tokens_per_sec"]
            r["wall_s"] = wall
            rs, _, _ = ext_run(dec, reqs, temperature=TP_TEMP, **TP_ENGINE)
            r["sampled"] = [x.tokens for x in rs]
            r["profile"] = profile_decode("serving_tp tp=1", dec, prompts)
        log(f"[serving_tp] tp=1 {dtype} references in "
            f"{time.perf_counter() - t0:.1f} s")
        del dec, model
        torch.cuda.empty_cache()

    def drive(dtype, name, dec, ekw, temp):
        r = ref[dtype]
        rs, eng, wall = ext_run(
            dec, reqs, temperature=temp, **ekw, **TP_ENGINE,
            handoffs=r["handoffs"] if name == "handoff" else None)
        ids = [x.tokens for x in rs]
        want = r["paged"] if name in ("handoff", "speculative") \
            else r[name]
        if name == "speculative":
            want = out["bfloat16 paged"]["ids"]      # tp = 2 one-token
        div = first_divergence(want, ids)
        same = sum(a == b for a, b in zip(want, ids))
        summ = eng.recorder.summary()
        out[f"{dtype} {name}"] = {
            "ids": ids, "requests_equal": f"{same} of {len(reqs)}",
            "first_divergence": div, "wall_s": wall,
            "tokens_per_s": summ["tokens_per_sec"],
            "accept_rate": summ.get("accept_rate")}
        log(f"[serving_tp {dtype} {name}] tp=2 vs "
            f"{'tp=2 one-token' if name == 'speculative' else 'tp=1'}: "
            f"{same} of {len(reqs)} requests equal, first divergence "
            f"{div}; tokens/s {summ['tokens_per_sec']:.2f}, wall "
            f"{wall:.2f} s, accept rate {summ.get('accept_rate')} on "
            f"{card}")
        if dtype == "float32" and div is not None:
            raise AssertionError(f"serving_tp fp32 {name}: tp=2 ids differ "
                                 f"from tp=1's at {div}")
        if (dtype, name) == ("bfloat16", "paged"):
            # a decode step's device and wall time, off the same decoder
            out["profile"] = profile_decode("serving_tp tp=2", dec, prompts)

    def watch():
        """Rank 1 failing leaves this rank blocked in its next
        collective: end the run instead."""
        while not released.wait(1.0):
            if follower.poll() not in (None, 0):
                log(f"serving_tp: rank 1 exited {follower.returncode}:\n"
                    + log_path.read_text()[-4000:])
                os._exit(1)

    released = threading.Event()
    threading.Thread(target=watch, daemon=True).start()
    try:
        group = ModelGroup.join(dev, 0, TP, init, backend="gloo")
        t0 = time.perf_counter()
        gathered = tp_rank_sessions(dev, group, n_layers, before, drive)
        sessions_s = time.perf_counter() - t0
    finally:
        released.set()
        destroy_group()
        try:
            follower.wait(timeout=120)
        except subprocess.TimeoutExpired:
            follower.kill()
            follower.wait()
    if follower.returncode != 0:
        raise AssertionError(f"serving_tp: rank 1 exited "
                             f"{follower.returncode}:\n"
                             + log_path.read_text()[-4000:])

    # the bf16 first decode step's logits, both ranks' vocab shards
    got = np.concatenate([g[1] for g in gathered], axis=1)
    want = ref["bfloat16"]["logits"]
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    top_same = int((got.argmax(1) == want.argmax(1)).sum())
    logit_line = {"shape": list(got.shape), "relative_l2": rel,
                  "max_abs": float(np.abs(got - want).max()),
                  "rows_same_argmax": f"{top_same} of {got.shape[0]}",
                  "rtol": TP_LOGITS_RTOL}
    log(f"[serving_tp bf16 logits] first decode step tp=2 vs tp=1: "
        f"{json.dumps(logit_line)}")
    if not rel <= TP_LOGITS_RTOL:
        raise AssertionError(f"serving_tp: bf16 logits at tp=2 are {rel} "
                             f"(relative L2) from tp=1's")
    # every rank launched every kernel of its sessions
    per_rank = {f"rank{r}": g[0] for r, g in enumerate(gathered)}
    log(f"[serving_tp launches] {json.dumps(per_rank)}")
    for name, c0 in per_rank["rank0"].items():
        c1 = per_rank["rank1"][name]
        want_k1 = " v1" in name
        # each K4 launch on its session's dtype's route
        k4_route = routes_want(name.split()[0], {"K4": c0["K4"]})["K4"]
        if c0["rms_norm"] != c1["rms_norm"] or not c0["rms_norm"] \
                or bool(c0["K1"]) != want_k1 or bool(c1["K1"]) != want_k1 \
                or bool(c0["K4"]) == want_k1 or c0["K4"] != c1["K4"] \
                or c0["K4_route"] != k4_route or c1["K4_route"] != k4_route:
            raise AssertionError(f"serving_tp {name}: launches {c0} / {c1}")
    rates = {"tp1": ref["bfloat16"]["tokens_per_s"],
             "tp2": out["bfloat16 paged"]["tokens_per_s"]}
    step = {k: {m: p[m] for m in ("wall_ms_per_step", "device_ms_per_step",
                                  "busy_share")}
            for k, p in (("tp1", ref["bfloat16"]["profile"]),
                         ("tp2", out["profile"]))}
    log(f"[serving_tp] bf16 decode tokens/s {json.dumps(rates)}; a decode "
        f"step {json.dumps(step)} (rank 0; tp=2 over gloo staging through "
        f"the host); sessions {sessions_s:.1f} s on {card}")
    out["tcp"] = tp_tcp_arm(dev, reqs)
    # the v1 sessions are fp32 (K1 in three TF32 passes); K4 by dtype
    for k, key, dtype in (("K1 fp32", "K1", ""), ("K4", "K4", "bfloat16"),
                          ("K4 fp32", "K4", "float32"),
                          ("rms_norm", "rms_norm", "")):
        if k in records:
            add_launches(records[k], **{
                f"serving_tp_{r}": sum(c[key] for sess, c in counts.items()
                                       if sess.startswith(dtype))
                for r, counts in per_rank.items()})


def tp_tcp_arm(dev, reqs) -> dict:
    """A tp = 2 ``ReplicaServer`` (``python -m ...serving.replica`` with
    ``config["tp"] = 2``, devices card 0 twice, gloo), fp32 at full
    width and ``FLEET_TCP_LAYERS`` deep, restored from a checkpoint
    this process writes; ``TP_TCP_REQUESTS`` requests over TCP give the
    ids of a tp = 1 engine in this process over the same weights."""
    import torch

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.models.llama import params_to_jax
    from theanompi_tpu_torch.serving import (
        PagedLlamaDecoder,
        Request,
        TCPReplicaClient,
    )
    from theanompi_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = tp_config("float32", FLEET_TCP_LAYERS)
    model = Llama(cfg, device=dev)
    ckpt = ROOT / "build" / "serving_tp_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    save_checkpoint(ckpt, 0, {"params": params_to_jax(model.params)})
    reqs = [p[:200] for p in reqs[:TP_TCP_REQUESTS]]
    rs, _, _ = ext_run(PagedLlamaDecoder(model, **FLEET_KW), reqs)
    want = [r.tokens for r in rs]
    del model, rs
    torch.cuda.empty_cache()
    spec = dict(config=dict(cfg, tp=TP), checkpoint=str(ckpt),
                devices=[str(dev)] * TP, backend="gloo", paged=True,
                decoder=FLEET_KW, engine={"prefix_caching": False},
                name="tp2")
    t0 = time.perf_counter()
    proc, port = start_replica_child(spec)
    ready_s = time.perf_counter() - t0
    client = None
    try:
        client = TCPReplicaClient(("127.0.0.1", port), name="tp2",
                                  ping_interval_s=0.05, slots=8)
        t0 = time.perf_counter()
        futs = [client.submit(Request(prompt=list(p), max_tokens=32,
                                      seed=i))
                for i, p in enumerate(reqs)]
        got = [f.result(timeout=600).tokens for f in futs]
        wall = time.perf_counter() - t0
        client.shutdown()
        code = proc.wait(timeout=120)
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)
    line = {"requests": len(reqs), "ids_equal_tp1": got == want,
            "child_ready_s": ready_s, "wall_s": wall, "exit_code": code}
    log(f"[serving_tp tcp] {json.dumps(line)} on {card_line()}")
    if got != want or code != 0:
        raise AssertionError(f"serving_tp tcp: ids {got} vs tp=1 {want}, "
                             f"exit {code}")
    return line


# -- training ----------------------------------------------------------------

TRAIN_SMALL = dict(SMALL, batch_size=2, n_train=6, n_val=2, lr=1e-3)
LLAMA = dict(modelfile="theanompi_tpu_torch.models.llama", modelclass="Llama")


def bsp(devices, config, model=LLAMA, **kw) -> dict:
    """One in-process BSP run of ``model`` (modelfile and modelclass)
    through the rule API; its summary."""
    from theanompi_tpu_torch import BSP

    rule = BSP()
    rule.init(devices=devices, launch="inprocess", config=config,
              n_epochs=1, **model, **kw)
    return rule.wait()


def check_training_reference(dev) -> None:
    """A small fp32 Llama trained 3 BSP steps on the card (K1-K3,
    cuBLAS, a one-rank NCCL group) and on the CPU (plain versions,
    gloo) from one initial checkpoint: per-step losses must agree."""
    import numpy as np

    from theanompi_tpu_torch.models.llama import save_init_checkpoint

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        init = Path(tmp) / "init"
        save_init_checkpoint(TRAIN_SMALL, init)
        losses = []
        for devices in ([dev.index], ["cpu"]):
            d = Path(tmp) / str(devices[0])
            shutil.copytree(init, d)
            out = bsp(devices, TRAIN_SMALL, checkpoint_dir=str(d),
                      resume=True, verbose=False)
            losses.append(out["recorder"].train_losses)
    ok = len(losses[0]) == 3 and np.allclose(losses[0], losses[1],
                                             rtol=TRAIN_REF_RTOL, atol=0)
    log(f"reference [training] small fp32 model, 3 BSP steps, card "
        f"{losses[0]} vs CPU {losses[1]} (rtol {TRAIN_REF_RTOL}): "
        f"{'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError("training: card and CPU losses differ")


def run_training(dev, n_layers: int, counters: dict, name: str = "training",
                 profile: bool = False, **extra) -> tuple[dict, object]:
    """BSP at Llama-3-8B widths through ``BSP().init`` (``ici32``, or
    what the ``extra`` config keys name: an exchange, the device-resident
    chunk, ``remat_save``): each step timed (the device synchronized
    around it; a ``train_chunk`` call around the chunk, each of its steps
    charged the chunk's time over K), K1/K2/K3 launches counted over the
    run (train steps and val; K1 2L a step under full remat, L with
    ``remat_save=("attn_out",)``).  ``profile``: the run also takes
    ``step_profile`` and ``trace`` (``check_step_profile``).  Returns
    (numbers, the trained model)."""
    import torch

    from theanompi_tpu_torch.models import LLAMA3_8B, Llama

    steps, val_batches, batch, seq = 8, 2, 2, 2048
    cfg = dict(LLAMA3_8B, n_layers=n_layers, seq_len=seq, batch_size=batch,
               n_train=steps * batch, n_val=val_batches * batch,
               compute_dtype="bfloat16", optimizer="adam", lr=1e-4,
               remat=True, xent_chunks="auto", exch_strategy="ici32", seed=0)
    cfg.update(extra)
    export = None
    if profile:
        export = Path(tempfile.mkdtemp(dir=ROOT / "build")) / "trace.json"
        cfg.update(step_profile=True, trace=True, trace_export=str(export))
    times, inside = [], []
    train_iter, train_chunk = Llama.train_iter, Llama.train_chunk

    def timed(self, count, recorder, k=None):
        # one clock around the outermost call (a cached train_iter is a
        # chunk of one)
        if inside:
            return (train_iter(self, count, recorder) if k is None
                    else train_chunk(self, count, k, recorder))
        inside.append(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if k is None:
                train_iter(self, count, recorder)
            else:
                train_chunk(self, count, k, recorder)
            torch.cuda.synchronize()
        finally:
            inside.clear()
        times.extend([(time.perf_counter() - t0) / (k or 1)] * (k or 1))

    def timed_chunk(self, count, k, recorder):
        timed(self, count, recorder, k)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters.values())
    Llama.train_iter, Llama.train_chunk = timed, timed_chunk
    try:
        out = bsp([dev.index], cfg, print_freq=1)
    finally:
        Llama.train_iter, Llama.train_chunk = train_iter, train_chunk
    launches = {k: fn.launches for k, fn in counters.items()}
    tc_launches = {k: fn.tc_launches for k, fn in counters.items()
                   if hasattr(fn, "tc_launches")}
    model = out["model"]
    losses = out["recorder"].train_losses
    # the profile's steps ran through the same timed train_iter
    med = statistics.median(times[1:steps])
    tokens = batch * seq
    counted = steps + (PROFILE_STEPS if profile else 0)
    # the forward once a step with the attention output kept, twice
    # under full remat
    k1_step = n_layers * (1 if "attn_out" in cfg.get("remat_save", ())
                          else 2)
    res = {
        "config": {k: cfg[k] for k in ("dim", "n_layers", "n_heads",
                                       "n_kv_heads", "ffn_dim", "vocab",
                                       "seq_len", "batch_size",
                                       "exch_strategy")},
        "extra": extra,
        "params_b": model.n_params() / 1e9,
        "xent_chunks": model._n_xent_chunks,
        "losses": losses, "val": out["final_val"],
        "step_s": times[:steps], "median_step_s": med,
        "tokens_per_s": tokens / med,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "tc_launches": tc_launches,
        "launches_per_step": {
            "K1": (launches["K1"] - val_batches * n_layers) / counted,
            "K2": launches["K2"] / counted, "K3": launches["K3"] / counted,
        },
        "chunk": model._chunk_k,
    }
    log(f"[{name}] {json.dumps(res)} on {card_line()}")
    if profile:
        res["step_profile"] = check_step_profile(name, out, steps, export)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: last loss {losses[-1]} is not below "
                             f"the first {losses[0]}")
    want = {"K1": counted * k1_step + val_batches * n_layers,
            "K2": counted * n_layers, "K3": counted * n_layers}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want} "
                             f"({k1_step}/L/L per step, L per val "
                             f"batch, {counted} steps)")
    for k in tc_launches:
        check_tc_route(f"{name} {k}", counters[k])
    if res["xent_chunks"] != 24:
        raise AssertionError(f"{name}: {res['xent_chunks']} head chunks")
    return res, model


def host_to_device_mode():
    """A dispatch mode that counts the operations which read a host
    tensor into a device one (a copy from the host, or a host operand
    of more than one element to a device op) and the bytes they read:
    every such copy the calling thread (and the autograd engine's, which
    inherits the mode) makes through torch, whoever makes it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    aten = torch.ops.aten
    copies = {aten.copy_, aten._to_copy, aten.copy, aten._copy_from,
              aten._copy_from_and_resize}

    class HostToDevice(TorchDispatchMode):
        ops = 0
        bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.device.type != "cpu"
                   for t in tree_flatten(out)[0]):
                copy = func.overloadpacket in copies
                src = [t for t in tree_flatten((args, kwargs))[0]
                       if isinstance(t, torch.Tensor)
                       and t.device.type == "cpu" and (copy or t.dim() > 0)]
                if src:
                    self.ops += 1
                    self.bytes += sum(t.numel() * t.element_size()
                                      for t in src)
            return out

    return HostToDevice()


def host_traffic(fn) -> dict:
    """``fn()`` under ``torch.profiler`` (host and device activities) and
    ``host_to_device_mode``: its host-to-device copies counted on the
    host at dispatch (``h2d_ops``, ``h2d_op_bytes``), the batch bytes
    the ``HostStager`` sent to the card (``staged_bytes``), the CUDA
    runtime's memcpy calls and its synchronizing calls by name made
    while ``fn`` ran (host events, always recorded; the closing
    ``cudaDeviceSynchronize`` and the profiler's own lie outside), and
    the device trace's host-to-device and device-to-host memcpys
    (count, bytes: kept in some runs and not in others)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from theanompi_tpu_torch.data.pipeline import HostStager

    staged = [0]
    stage = HostStager.stage

    def counted(self, batch):
        out = stage(self, batch)
        staged[0] += sum(t.numel() * t.element_size() for t in out.tensors)
        return out

    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    torch.cuda.synchronize()
    HostStager.stage = counted
    mode = host_to_device_mode()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("host_traffic.fn"), mode:
                fn()
            torch.cuda.synchronize()
    finally:
        HostStager.stage = stage
    prof.export_chrome_trace(str(tmp / "traffic.json"))
    events = json.loads((tmp / "traffic.json").read_text())["traceEvents"]
    shutil.rmtree(tmp, ignore_errors=True)
    span = [e for e in events if e.get("name") == "host_traffic.fn"
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        raise AssertionError(f"host_traffic: {len(span)} spans of fn in "
                             f"the trace")
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])
    out = {"staged_bytes": staged[0], "h2d_ops": mode.ops,
           "h2d_op_bytes": mode.bytes, "memcpy_calls": 0,
           "h2d_copies": 0, "h2d_bytes": 0, "d2h_copies": 0,
           "d2h_bytes": 0, "syncs": {}}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "gpu_memcpy":
            for way, key in (("HtoD", "h2d"), ("DtoH", "d2h")):
                if way in name:
                    out[f"{key}_copies"] += 1
                    out[f"{key}_bytes"] += int(e.get("args", {}).get(
                        "bytes", 0))
        elif cat in ("cuda_runtime", "cuda_driver") and \
                lo <= float(e.get("ts", -1)) <= hi:
            if "Memcpy" in name or "memcpy" in name:
                out["memcpy_calls"] += 1
            if "Synchronize" in name or name in ("cudaMemcpy",
                                                 "cuMemcpy"):
                out["syncs"][name] = out["syncs"].get(name, 0) + 1
    out["n_syncs"] = sum(out["syncs"].values())
    return out


def check_no_host_traffic(name: str, traffic: dict) -> None:
    """A device-resident chunk sends no byte to the card (at the stager,
    at dispatch and in the device trace) and makes no host sync."""
    if (traffic["staged_bytes"] or traffic["h2d_ops"]
            or traffic["h2d_bytes"] or traffic["n_syncs"]):
        raise AssertionError(f"{name}: a chunk sent bytes to the card or "
                             f"synced the host: {traffic}")


#: the training cell's device-resident arm: ``steps_per_call`` 4, its 8
#: steps two chunks
TRAIN_CHUNK = 4


def chunk_ab(model, k: int) -> dict:
    """A device-resident model's steps taken one a call against ``k`` a
    call, in turns (one, chunk, chunk, one: ``k`` steps each), each call
    closed by its recorder's read of the losses, as the worker's is at
    ``print_freq=1``: ms a step of each turn, and the host syncs and
    host-to-device bytes of one call of each (``host_traffic``)."""
    import torch

    from theanompi_tpu_torch.utils import Recorder

    rec = Recorder(verbose=False)

    def one_at_a_time():
        for j in range(k):
            model.train_iter(j, rec)
            rec.flush()

    def chunk():
        model.train_chunk(0, k, rec)
        rec.flush()

    def ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    turns = [("one", one_at_a_time), ("chunk", chunk), ("chunk", chunk),
             ("one", one_at_a_time)]
    out = {"one_ms_per_step": [], "chunk_ms_per_step": []}
    for name, fn in turns:
        out[f"{name}_ms_per_step"].append(ms(fn))
    out["one_traffic"] = host_traffic(lambda: model.train_iter(0, rec))
    out["chunk_traffic"] = host_traffic(lambda: model.train_chunk(0, k, rec))
    return out


def run_training_arms(dev, n_layers: int, counters: dict,
                      records: dict) -> None:
    """The training cell twice more (module docstring, phase 7): the
    train set on the card with ``steps_per_call`` = ``TRAIN_CHUNK`` (two
    chunks; the losses bitwise the staged ``ici32`` run's; one step a
    call against a chunk in turns, and the host-to-device bytes and
    host syncs of one more chunk, asserted none, beside one staged
    step's: ``chunk_ab``) and ``remat_save=("attn_out",)`` (K1 L a step,
    which ``run_training`` asserts; the losses bitwise full remat's;
    peak memory and step beside full remat's)."""
    import torch

    ref = TRAINED.get("ici32")
    arms = {}
    for arm, extra in (("chunk", dict(device_data_cache=True,
                                      steps_per_call=TRAIN_CHUNK)),
                       ("remat_save", dict(remat_save=("attn_out",)))):
        res, model = run_training(dev, n_layers, counters,
                                  name=f"training {arm}", **extra)
        if arm == "chunk":
            if res["chunk"] != TRAIN_CHUNK:
                raise AssertionError(f"training chunk: the model runs "
                                     f"{res['chunk']} steps a call")
            res["ab"] = chunk_ab(model, TRAIN_CHUNK)
            res["traffic_per_chunk"] = res["ab"]["chunk_traffic"]
            log(f"[training chunk] one step a call against "
                f"{TRAIN_CHUNK} a call, in turns: {json.dumps(res['ab'])} "
                f"on {card_line()}")
        arms[arm] = res
        del model
        torch.cuda.empty_cache()
        for k in counters:
            add_launches(records.setdefault(k, {}),
                         **{f"training_{arm}": res["launches"][k]})
    side = {"ici32": ref} if ref is not None else {}
    side.update(arms)
    log("[training arms] " + json.dumps({
        k: {"median_step_s": v["median_step_s"], "step_s": v["step_s"],
            "tokens_per_s": v["tokens_per_s"], "peak_gib": v["peak_gib"],
            "launches_per_step": v["launches_per_step"],
            "traffic": v.get("traffic_per_chunk",
                             v.get("traffic_per_step"))}
        for k, v in side.items()}) + f" on {card_line()}")
    check_no_host_traffic("training chunk",
                          arms["chunk"]["traffic_per_chunk"])
    if ref is None or ref["config"]["n_layers"] != n_layers:
        log("[training arms] no ici32 run at this depth in this run: the "
            "arms held to TRAIN_TRAJECTORY")
        for arm, res in arms.items():
            check_train_trajectory(f"training {arm}", res)
        return
    for arm, res in arms.items():
        same = res["losses"] == ref["losses"]
        log(f"[training {arm}] losses {res['losses']} against the staged "
            f"full-remat run's {ref['losses']}: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"training {arm}: losses differ from the "
                                 f"staged full-remat run's")


def check_step_profile(name: str, out: dict, steps: int,
                       export: Path) -> dict:
    """The BSP summary's ``step_profile`` and ``trace_spans`` after a
    run with both knobs on (``run_training(profile=True)``): the legs,
    coverage, MFU against the H100's peak, the span count, the export
    and ``metrics_txt``; any miss fails the phase.  Returns the profile
    with its legs in ms."""
    from theanompi_tpu_torch.utils.scaling_model import H100

    prof = out["step_profile"]
    if not isinstance(prof, dict) or "error" in prof:
        raise AssertionError(f"{name}: step profile failed: {prof}")
    legs = prof["legs"]
    summary = {
        "legs_ms": {k: v["time_s"] * 1e3 for k, v in legs.items()},
        "step_ms": prof["step_s"] * 1e3,
        "device_busy_ms": prof["device_busy_s"] * 1e3 / prof["n_steps"],
        "coverage": prof["coverage"], "measured_mfu": prof["measured_mfu"],
        "step_flops": prof["step_flops"],
        "exposed_comm_ms": prof["exposed_comm_s"] * 1e3,
        "gap_ms": {k: v * 1e3 for k, v in (prof["gap"] or {}).get(
            "legs", {}).items()},
        "ideal_step_ms": (prof["gap"] or {}).get("ideal_step_s", 0) * 1e3,
        "trace_spans": out["trace_spans"],
    }
    log(f"[{name}] step profile {json.dumps(summary)} on {card_line()}")
    missing = [k for k in ("compute", "optimizer", "host_gap") if k not in legs]
    if missing or not any(k.startswith("exchange_b") for k in legs):
        raise AssertionError(f"{name}: profile legs {list(legs)} lack "
                             f"{missing or 'an exchange_b leg'}")
    lo, hi = PROFILE_COVERAGE
    if not lo <= prof["coverage"] <= hi:
        raise AssertionError(f"{name}: coverage {prof['coverage']}")
    mfu, flops = prof["measured_mfu"], prof["step_flops"]
    want = (flops / (prof["step_s"] * prof["n_devices"] * H100.peak_bf16)
            if flops else None)
    if mfu is None or not 0 < mfu <= 1 or abs(mfu - want) > 1e-9 * want:
        raise AssertionError(f"{name}: MFU {mfu}, want {want} from "
                             f"{flops} FLOPs at {H100.peak_bf16:g}/s")
    # each iteration is a root with its load and step spans; the root
    # the last boundary opened closes at the run's end
    if out["trace_spans"] != 3 * steps + 1:
        raise AssertionError(f"{name}: {out['trace_spans']} spans, want "
                             f"{3 * steps + 1}")
    events = json.loads(export.read_text())["traceEvents"]
    n_iter = sum(e.get("name") == "iteration" and e.get("ph") == "X"
                 for e in events)
    counters = {e["name"] for e in events if e.get("ph") == "C"}
    if n_iter != steps + 1 or "step_phase_s:Llama" not in counters:
        raise AssertionError(f"{name}: export holds {n_iter} iterations, "
                             f"counters {sorted(counters)}")
    txt = out["recorder"].metrics_txt(world_size=1)
    for family in ("tm_train_iterations_total", "tm_train_seconds_total",
                   "tm_train_steps_per_sec", "tm_train_loss"):
        if family not in txt:
            raise AssertionError(f"{name}: metrics_txt lacks {family}")
    summary["legs"] = list(legs)
    return summary


def check_step_flops(name: str, model, res: dict) -> None:
    """The count behind the profile's MFU: ``train_step_flops()`` once
    more on the trained model, its K1-K3 part (``count_kernel_ops``)
    against ``flash_ops`` of the step's launches (with remat: per layer
    two K1, the forward and its replay, one K2 and one K3, causal at
    [batch, heads, seq, head dim]), and the whole equal to the
    profile's ``step_flops`` (one rank).  Launches made here come after
    the run's counts were read."""
    from theanompi_tpu_torch.ops.attention import count_kernel_ops

    c = res["config"]
    shape = (c["batch_size"], c["n_heads"], c["seq_len"],
             c["dim"] // c["n_heads"])
    with count_kernel_ops() as ops:
        total = model.train_step_flops()
    kernels = ops[0]
    want = c["n_layers"] * (2 * flash_ops("fwd", shape)
                            + flash_ops("dkv", shape) + flash_ops("dq", shape))
    prof = res["step_profile"]["step_flops"]
    res["step_flops"] = {"total": total, "kernels": kernels,
                         "products": total - kernels, "kernels_want": want}
    log(f"[{name}] step FLOPs {json.dumps(res['step_flops'])}: kernels "
        f"against L*(2*K1 + K2 + K3) at {list(shape)} causal, the total "
        f"against the profile's {prof}")
    if abs(kernels - want) > 1e-12 * want:
        raise AssertionError(f"{name}: K1-K3 operations {kernels}, want "
                             f"{want}")
    if abs(total - prof) > 1e-12 * prof:
        raise AssertionError(f"{name}: train_step_flops {total} against "
                             f"the profile's {prof}")


def check_profile_busy(name: str, res: dict) -> None:
    """The step profile's device busy time a step against
    ``profile_training``'s device time a step, within
    ``PROFILE_BUSY_RTOL``."""
    got = res["step_profile"]["device_busy_ms"]
    ref = res["profile"]["device_ms_per_step"]
    rel = abs(got - ref) / ref
    log(f"[{name}] step profile busy {got:.2f} ms a step against the "
        f"2-step profile's {ref:.2f} ms: {rel:.3%} (rtol "
        f"{PROFILE_BUSY_RTOL})")
    if rel > PROFILE_BUSY_RTOL:
        raise AssertionError(f"{name}: profile busy {got} ms against {ref}")


def check_train_trajectory(name: str, res: dict) -> None:
    """The first and last loss and the val loss at the default depth
    (8 layers) against ``TRAIN_TRAJECTORY``."""
    if res["config"]["n_layers"] != 8:
        return
    got = {"first": res["losses"][0], "last": res["losses"][-1],
           "val": res["val"]["loss"]}
    rel = {k: abs(got[k] - v) / v for k, v in TRAIN_TRAJECTORY.items()}
    log(f"[{name}] losses {got} against {TRAIN_TRAJECTORY}: relative "
        f"differences {rel} (rtol {TRAIN_TRAJECTORY_RTOL})")
    if max(rel.values()) > TRAIN_TRAJECTORY_RTOL:
        raise AssertionError(f"{name}: losses left the reference trajectory")


# cuDNN's convolution kernels carry xmma/cutlass names too: matched
# before the GEMM rule
CONV_KEYS = ("fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_convolve",
             "conv2d", "convolve", "cudnn")
POOL_KEYS = ("max_pool", "avg_pool", "pool2d")


def kernel_kind(name: str) -> str:
    """The group a profiled device kernel's name puts it in."""
    low = name.lower()
    if any(k in low for k in CONV_KEYS):
        return "conv (cuDNN)"
    if any(k in low for k in POOL_KEYS):
        return "pooling"
    for key, kind in (("flash_fwd_tc_kernel", "K1 flash_fwd_tc"),
                      ("flash_bwd_dkv_tc_kernel", "K2 flash_bwd_dkv_tc"),
                      ("flash_bwd_dq_tc_kernel", "K3 flash_bwd_dq_tc"),
                      ("flash_fwd_tf32x3_kernel", "K1 flash_fwd_tf32x3"),
                      ("flash_bwd_dkv_tf32x3_kernel",
                       "K2 flash_bwd_dkv_tf32x3"),
                      ("flash_bwd_dq_tf32x3_kernel", "K3 flash_bwd_dq_tf32x3"),
                      ("paged_split", "K4 paged_split"),
                      ("paged_combine", "K4 paged_combine"),
                      ("rms_norm_kernel", "rms_norm"),
                      ("nccl", "NCCL"), ("Memcpy", "memcpy/memset"),
                      ("Memset", "memcpy/memset"),
                      ("softmax", "loss (softmax, nll)"),
                      ("nll_loss", "loss (softmax, nll)"),
                      ("elementwise", "elementwise"),
                      ("reduce", "reductions")):
        if key in name:
            return kind
    if name.startswith("nvjet") or any(
            k in name.lower() for k in ("gemm", "xmma", "cutlass")):
        return "GEMM (cuBLAS)"
    return "other"


def profile_step(step, steps: int, name: str) -> dict:
    """Where a step's time goes: ``steps`` calls of ``step(i)`` traced
    as ``trace_steps`` does, with the device time also summed by kind
    of kernel."""
    out, kernels = trace_steps(step, steps, top=10)
    by_kind, names = {}, {}
    for k, ms in kernels:
        by_kind[kernel_kind(k)] = by_kind.get(kernel_kind(k), 0.0) + ms
        names.setdefault(kernel_kind(k), []).append((k[:100], ms))
    out["device_ms_per_step_by_kind"] = dict(
        sorted(by_kind.items(), key=lambda kv: -kv[1]))
    # the largest kernels of each kind (``kernels`` is sorted by time):
    # what a kind's name rule caught
    out["top_kernels_by_kind"] = {kind: dict(top[:3])
                                  for kind, top in names.items()}
    log(f"[{name}] step profile {json.dumps(out)} on {card_line()}")
    return out


def profile_training(model, steps: int = 2, name: str = "training",
                     start: int = 0) -> dict:
    """``profile_step`` over ``steps`` more steps of the trained model.
    The steps take batches ``start``, ``start + 1``, ... in order
    (wrapping at the epoch's end), so a streaming feed's ring keeps
    running across them."""
    import itertools

    from theanompi_tpu_torch.utils import Recorder

    rec = Recorder(verbose=False)
    nb = model.data.n_batch_train
    order = itertools.count(start)
    return profile_step(lambda i: model.train_iter(next(order) % nb, rec),
                        steps, name)


# -- the CNN classifier path -------------------------------------------------

WRESNET = dict(modelfile="theanompi_tpu_torch.models.wresnet",
               modelclass="WResNet")
RESNET50 = dict(modelfile="theanompi_tpu_torch.models.resnet50",
                modelclass="ResNet50")
ALEXNET = dict(modelfile="theanompi_tpu_torch.models.alex_net",
               modelclass="AlexNet")
VGG16 = dict(modelfile="theanompi_tpu_torch.models.vgg16",
             modelclass="VGG16")
GOOGLENET = dict(modelfile="theanompi_tpu_torch.models.googlenet",
                 modelclass="GoogLeNet")
CNN_SMALL = dict(depth=10, widen=1, batch_size=8, n_train=24, n_val=8,
                 compute_dtype="float32", seed=3, lr=0.02)
# the published configs: ImageNet shapes (crop 224, 1000 classes),
# batch 128 per card, bf16 compute over fp32 master weights
CNN_STEPS, CNN_VAL_BATCHES, CNN_BATCH = 8, 2, 128
RESNET50_CFG = dict(crop=224, batch_size=CNN_BATCH,
                    n_train=CNN_STEPS * CNN_BATCH,
                    n_val=CNN_VAL_BATCHES * CNN_BATCH,
                    compute_dtype="bfloat16", lr=0.1, momentum=0.9,
                    weight_decay=1e-4, exch_strategy="ici32", seed=0)
ALEXNET_CFG = dict(RESNET50_CFG, lr=0.01, weight_decay=5e-4)
# VGG16 and GoogLeNet at the JAX package's defaults: batch 32 a card,
# lr 0.01, weight decay 5e-4 / 2e-4
VGG_BATCH = 32
VGG16_CFG = dict(RESNET50_CFG, batch_size=VGG_BATCH,
                 n_train=CNN_STEPS * VGG_BATCH,
                 n_val=CNN_VAL_BATCHES * VGG_BATCH, lr=0.01,
                 weight_decay=5e-4)
GOOGLENET_CFG = dict(VGG16_CFG, weight_decay=2e-4)
# the four feeds of the ResNet-50 run: the pinned stager inside the
# step, the streaming feed (a producer thread, 2 slots), the train set
# on the card gathered there a step at a time, and in chunks of four
# steps a call (steps_per_call)
FEEDS = {"synchronous": {}, "pipelined": {"loader_pipeline": 2},
         "device_cache": {"device_data_cache": True},
         "device_cache_chunk": {"device_data_cache": True,
                                "steps_per_call": 4}}
# the torch.nn zoo (flax_zoo's counterpart): ResNet-18 at flax_zoo's
# width 64 on synthetic CIFAR-10 (32 x 32), batch 128, at the JAX
# defaults' precision (the batch cast to bf16, linen's promotion runs
# the fp32 parameters' products in fp32), lr 0.1; the CNN (width 32)
# under EASGD with two replicas on the card, tau 2, one epoch of
# ZOO_EASGD_STEPS iterations
ZOO_R18 = dict(modelfile="theanompi_tpu_torch.models.torch_zoo",
               modelclass="TorchResNet18")
ZOO_CNN = dict(ZOO_R18, modelclass="TorchCNN")
ZOO_R18_CFG = dict(width=64, batch_size=CNN_BATCH,
                   n_train=CNN_STEPS * CNN_BATCH,
                   n_val=CNN_VAL_BATCHES * CNN_BATCH, lr=0.1, seed=0,
                   exch_strategy="ici32")
ZOO_EASGD_STEPS = 8
ZOO_CNN_CFG = dict(width=32, batch_size=CNN_BATCH,
                   n_train=ZOO_EASGD_STEPS * 2 * CNN_BATCH,
                   n_val=2 * CNN_BATCH, lr=0.05, seed=0)


def card_vs_cpu_val(dev, cls, cfg, train_loss: bool = False) -> None:
    """``cls`` at ``cfg`` (fp32) built on the CPU, its parameters copied
    to a second copy on the card: the val numbers of batch 0 and, with
    ``train_loss``, the train-mode loss (every ``Dropout`` at rate 0)
    on that batch must agree within ``CNN_REF_RTOL``."""
    import numpy as np
    import torch

    from theanompi_tpu_torch.ops.layers import Dropout
    from theanompi_tpu_torch.parallel.mesh import destroy_group

    vals, trees = [], None
    for device in ("cpu", dev):
        model = cls(cfg, device=device)
        model.build_model()
        if trees is None:
            trees = model.checkpoint_trees()
        else:
            model.restore_trees(trees)
        model.compile_iter_fns()
        got = list(model.val_iter(0, None))
        if train_loss:
            for m in model.net.modules():
                if isinstance(m, Dropout):
                    m.rate = 0.0
            x, y = model.put_batch(model.data.val_batch(0))
            with torch.no_grad():
                got.append(model.compute_loss(
                    model.net(model.prep_input(x), train=True), y).item())
        vals.append(got)
        destroy_group()
    ok = np.allclose(vals[1], vals[0], rtol=CNN_REF_RTOL, atol=1e-6)
    what = "val (loss, err, err5)" + (", train loss" if train_loss else "")
    log(f"reference [cnn] {cls.__name__} fp32 crop {cfg['crop']} {what}, "
        f"card {vals[1]} vs CPU {vals[0]} (rtol {CNN_REF_RTOL}): "
        f"{'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError(f"cnn: {cls.__name__} card and CPU differ")


def check_cnn_reference(dev) -> None:
    """A small fp32 WResNet-10-1 (crop 32, batch 8) trained 3 BSP steps
    on the card (cuDNN, a one-rank NCCL group) and on the CPU (gloo)
    from one initial checkpoint: the losses must agree within
    ``CNN_REF_RTOL``; then AlexNet (crop 64, batch 4), VGG16 (crop 32,
    batch 2) and GoogLeNet (fused, crop 96, batch 2: its aux heads'
    VALID 5x5 pool needs inception 4a, at crop/16, to be 5 or more)
    on one set of parameters on both, their val numbers and
    GoogLeNet's train-mode loss with the aux terms."""
    import numpy as np

    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.models.vgg16 import VGG16 as VGG16Model
    from theanompi_tpu_torch.models.wresnet import WResNet

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        init = Path(tmp) / "init"
        WResNet.save_init_checkpoint(CNN_SMALL, init)
        losses = []
        for where, devices in (("card", [dev.index]), ("cpu", ["cpu"])):
            d = Path(tmp) / where
            shutil.copytree(init, d)
            out = bsp(devices, CNN_SMALL, model=WRESNET,
                      checkpoint_dir=str(d), resume=True, verbose=False)
            losses.append(out["recorder"].train_losses)
    ok = len(losses[0]) == 3 and np.allclose(losses[0], losses[1],
                                             rtol=CNN_REF_RTOL, atol=0)
    log(f"reference [cnn] WResNet-10-1 fp32, 3 BSP steps, card {losses[0]} "
        f"vs CPU {losses[1]} (rtol {CNN_REF_RTOL}): "
        f"{'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError("cnn: WResNet card and CPU losses differ")
    small = dict(n_train=4, n_val=4, compute_dtype="float32", seed=3)
    card_vs_cpu_val(dev, AlexNet, dict(small, crop=64, batch_size=4))
    card_vs_cpu_val(dev, VGG16Model, dict(small, crop=32, batch_size=2))
    card_vs_cpu_val(dev, GoogLeNet, dict(small, crop=96, batch_size=2,
                                         fused_inception=True),
                    train_loss=True)


def bits_checksum(x) -> int:
    """A position-weighted sum of the bits of ``x`` (bf16 or fp32): equal
    for equal tensors, and moved by a changed or moved element."""
    import torch

    flat = x.contiguous().view(-1)
    ints = flat.view(torch.int16 if flat.element_size() == 2
                     else torch.int32).long()
    w = torch.arange(ints.numel(), device=x.device) % 65521 + 1
    return int((ints * w).sum())


def run_cnn(dev, name: str, model: dict, cfg: dict,
            **kw) -> tuple[dict, object]:
    """One epoch of ``model`` at ``cfg`` through ``BSP().init`` on the
    card (``kw``: more of its arguments, e.g. a checkpoint to resume):
    each step timed with the device synchronized around it (its
    Recorder wait and calc segments read around it too, and a checksum
    of the batch the net took, in the compute dtype, taken after it),
    then the val batches; losses finite and val numbers in range.
    Returns (numbers, the trained model)."""
    import torch

    from theanompi_tpu_torch.models.base import ClassifierModel

    times, segs, sums, seen, inside = [], [], [], [], []
    train_iter, prep = ClassifierModel.train_iter, ClassifierModel.prep_input
    train_chunk = ClassifierModel.train_chunk

    def timed(self, count, recorder, k=None):
        # one clock around the outermost call; a chunk of K charges each
        # of its steps the chunk's time and segments over K
        if inside:
            return (train_iter(self, count, recorder) if k is None
                    else train_chunk(self, count, k, recorder))
        inside.append(1)
        seen.clear()
        before = dict(recorder.total_segments)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if k is None:
                train_iter(self, count, recorder)
            else:
                train_chunk(self, count, k, recorder)
            torch.cuda.synchronize()
        finally:
            inside.clear()
        n = k or 1
        times.extend([(time.perf_counter() - t0) / n] * n)
        segs.extend([{m: (recorder.total_segments[m] - before[m]) / n
                      for m in ("wait", "calc")}] * n)
        sums.extend(bits_checksum(x.to(self.compute_dtype))
                    for x in seen[:n])

    def timed_chunk(self, count, k, recorder):
        timed(self, count, recorder, k)

    def stash(self, x):
        seen.append(x)
        return prep(self, x)

    torch.cuda.reset_peak_memory_stats()
    ClassifierModel.train_iter, ClassifierModel.prep_input = timed, stash
    ClassifierModel.train_chunk = timed_chunk
    try:
        out = bsp([dev.index], cfg, model=model, print_freq=1, **kw)
    finally:
        ClassifierModel.train_iter = train_iter
        ClassifierModel.prep_input = prep
        ClassifierModel.train_chunk = train_chunk
    trained = out["model"]
    losses, val = out["recorder"].train_losses, out["final_val"]
    med = statistics.median(times[1:])
    res = {
        "model": name, "config": cfg,
        "params_m": sum(p.numel() for p in trained.params) / 1e6,
        "losses": losses, "val": val, "step_s": times,
        "median_step_s": med,
        "images_per_s": trained.data.global_batch / med,
        "median_wait_s": statistics.median(s["wait"] for s in segs[1:]),
        "median_calc_s": statistics.median(s["calc"] for s in segs[1:]),
        "loader": out["loader"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "batch_checksums": sums,
    }
    log(f"[cnn {name}] {json.dumps(res)} on {card_line()}")
    if len(losses) != CNN_STEPS or not all(math.isfinite(x)
                                           for x in losses):
        raise AssertionError(f"cnn {name}: losses {losses}")
    if not (math.isfinite(val["loss"])
            and 0.0 <= val["err_top5"] <= val["err"] <= 1.0):
        raise AssertionError(f"cnn {name}: val {val}")
    return res, trained


def check_trajectory(name: str, res: dict, want: dict) -> None:
    """First and last training loss and the val loss of ``res`` against
    ``want`` within ``CNN_TRAJECTORY_RTOL``."""
    got = {"first": res["losses"][0], "last": res["losses"][-1],
           "val": res["val"]["loss"]}
    rel = {k: abs(got[k] - v) / v for k, v in want.items()}
    log(f"[{name}] losses {got} against {want}: relative "
        f"differences {rel} (rtol {CNN_TRAJECTORY_RTOL})")
    if max(rel.values()) > CNN_TRAJECTORY_RTOL:
        raise AssertionError(f"{name}: losses left the reference "
                             f"trajectory")


def profile_feed(model, name: str) -> dict:
    """The trained model's feed rebuilt (the run closed it), one warm
    step, then ``profile_training`` over the next batches in order (a
    model that runs K steps a call: one warm chunk, then two chunks
    traced, each charged over its K steps); the busy share and the
    memcpy device time a step."""
    from theanompi_tpu_torch.utils import Recorder

    model.compile_iter_fns()
    k = model._chunk_k
    try:
        if k:
            rec = Recorder(verbose=False)
            model.train_chunk(0, k, rec)
            out, kernels = trace_steps(
                lambda i: model.train_chunk(0, k, rec), 2, top=10)
            memcpy = sum(ms for name_, ms in kernels
                         if kernel_kind(name_) == "memcpy/memset")
            log(f"[{name}] chunk profile {json.dumps(out)} on "
                f"{card_line()}")
            return {"busy_share": out["busy_share"],
                    "wall_ms_per_step": out["wall_ms_per_step"] / k,
                    "device_ms_per_step": out["device_ms_per_step"] / k,
                    "memcpy_ms_per_step": memcpy / k}
        model.train_iter(0, Recorder(verbose=False))
        prof = profile_training(model, name=name, start=1)
    finally:
        model.close_feed()
    by_kind = prof["device_ms_per_step_by_kind"]
    return {"busy_share": prof["busy_share"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "memcpy_ms_per_step": by_kind.get("memcpy/memset", 0.0)}


def use_synthetic_data() -> None:
    """Point ``TM_DATA_DIR`` at an empty directory: every data module
    takes its synthetic path."""
    data_dir = ROOT / "build" / "no_data"
    data_dir.mkdir(parents=True, exist_ok=True)
    if any(data_dir.iterdir()):
        raise AssertionError(f"{data_dir} must be empty (synthetic data)")
    os.environ["TM_DATA_DIR"] = str(data_dir)


def write_tmb_dataset(root: Path) -> int:
    """``CNN_STEPS`` train and ``CNN_VAL_BATCHES`` val batches of
    ``CNN_BATCH`` random 256 x 256 uint8 images (seed 11) as ``.tmb``
    files under ``root/imagenet_batches``; returns the bytes written."""
    import numpy as np

    from theanompi_tpu_torch.native import write_tmb

    rng = np.random.default_rng(11)
    total = 0
    for split, n in (("train", CNN_STEPS), ("val", CNN_VAL_BATCHES)):
        d = root / "imagenet_batches" / split
        d.mkdir(parents=True)
        for b in range(n):
            x = rng.integers(0, 256, (CNN_BATCH, 256, 256, 3), np.uint8)
            y = rng.integers(0, 1000, CNN_BATCH).astype(np.int32)
            write_tmb(d / f"batch_{b:06d}.tmb", x, y)
            total += (d / f"batch_{b:06d}.tmb").stat().st_size
    return total


def run_tmb_feeds(dev, cached: dict) -> None:
    """ResNet-50 at the cnn config from ``.tmb`` files this run writes,
    fed by the C++ loader (``native.NativeBatchLoader``, built with g++
    at first use) and then by the prefetch thread (the loader turned
    off, as without a toolchain): ``feed`` is asserted for each, and
    the batches the net took are bitwise equal.  Each feed's median
    step and busy share beside the device-resident feed's (``cached``,
    synthetic data)."""
    import torch

    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    t0 = time.perf_counter()
    nbytes = write_tmb_dataset(tmp)
    log(f"[cnn tmb] wrote {nbytes / 1e6:.1f} MB of .tmb files in "
        f"{time.perf_counter() - t0:.1f} s")
    old = os.environ["TM_DATA_DIR"]
    old_native = os.environ.pop("TM_NATIVE", None)
    os.environ["TM_DATA_DIR"] = str(tmp)
    runs = {}
    try:
        for feed in ("native", "thread"):
            # TM_NATIVE=0 stands in for a host without a toolchain
            os.environ["TM_NATIVE"] = "1" if feed == "native" else "0"
            res, model = run_cnn(dev, f"resnet50 tmb {feed}", RESNET50,
                                 RESNET50_CFG)
            if model.data.feed != feed:
                raise AssertionError(f"cnn tmb: the {feed} run was fed by "
                                     f"{model.data.feed}")
            model.data.shuffle(1)
            res["profile"] = profile_feed(model, f"cnn resnet50 tmb {feed}")
            runs[feed] = res
            del model
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("TM_NATIVE")
        if old_native is not None:
            os.environ["TM_NATIVE"] = old_native
        os.environ["TM_DATA_DIR"] = old
        shutil.rmtree(tmp, ignore_errors=True)
    line = {feed: {"median_step_s": r["median_step_s"],
                   "images_per_s": r["images_per_s"],
                   "median_wait_s": r["median_wait_s"],
                   "busy_share": r["profile"]["busy_share"]}
            for feed, r in dict(runs, device_cache=cached).items()}
    log(f"[cnn resnet50 tmb feeds] {json.dumps(line)} (device_cache: "
        f"synthetic data on the card) on {card_line()}")
    if runs["native"]["batch_checksums"] != runs["thread"]["batch_checksums"]:
        raise AssertionError(f"cnn tmb: the native loader's batches differ "
                             f"from the thread's: "
                             f"{runs['native']['batch_checksums']} vs "
                             f"{runs['thread']['batch_checksums']}")
    log(f"[cnn tmb] the {CNN_STEPS} batches of the native loader are "
        f"bitwise the prefetch thread's")


def zoo_first_loss_on_cpu(cfg: dict) -> float:
    """``TorchResNet18``'s first training loss on the CPU: the forward
    of train batch 0 of epoch 0 (train mode) on the seeded init that
    ``save_init_checkpoint`` writes (the same CPU draws)."""
    import torch

    from theanompi_tpu_torch.models.torch_zoo import TorchResNet18

    model = TorchResNet18(cfg, device="cpu")
    model.build_model()
    model._init_input_mean()
    model.data.shuffle(0)
    x, y = model.data.train_batch(0)
    with torch.no_grad():
        out = model.net(model.prep_input(torch.as_tensor(x)), train=True,
                        gen=torch.Generator())
        return float(model.compute_loss(out, torch.as_tensor(y).long()))


def zoo_card_vs_cpu_val(dev) -> None:
    """``TorchCNN`` (fp32) built on the CPU, its parameters copied to a
    second copy on the card: the val numbers of batch 0 within
    ``CNN_REF_RTOL`` (its train loss takes a dropout mask, which the
    card's generator draws otherwise than the CPU's)."""
    import numpy as np

    from theanompi_tpu_torch.models.torch_zoo import TorchCNN
    from theanompi_tpu_torch.parallel.mesh import destroy_group

    cfg = dict(ZOO_CNN_CFG, compute_dtype="float32", n_val=CNN_BATCH)
    vals, trees = [], None
    for device in ("cpu", dev):
        model = TorchCNN(cfg, device=device)
        model.build_model()
        if trees is None:
            trees = model.checkpoint_trees()
        else:
            model.restore_trees(trees)
        model.compile_iter_fns()
        vals.append(list(model.val_iter(0, None)))
        destroy_group()
    ok = np.allclose(vals[1], vals[0], rtol=CNN_REF_RTOL, atol=1e-6)
    log(f"reference [cnn torch_zoo] TorchCNN fp32 val (loss, err, err5), "
        f"card {vals[1]} vs CPU {vals[0]} (rtol {CNN_REF_RTOL}): "
        f"{'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError("cnn: TorchCNN card and CPU differ")


def run_zoo_arm(dev) -> None:
    """The ``torch.nn`` zoo on the card: ``TorchResNet18`` under BSP at
    ``ZOO_R18_CFG`` from the seeded init (its first loss within
    ``CNN_REF_RTOL`` of the CPU's on that init), then ``TorchCNN``
    under EASGD with two replicas for one epoch (exchanges made; its
    val numbers held to the CPU's first)."""
    import torch

    from theanompi_tpu_torch.models.torch_zoo import TorchResNet18

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        init = Path(tmp) / "init"
        TorchResNet18.save_init_checkpoint(ZOO_R18_CFG, init)
        res, model = run_cnn(dev, "torch_zoo resnet18", ZOO_R18,
                             ZOO_R18_CFG, checkpoint_dir=str(init),
                             resume=True)
    del model
    torch.cuda.empty_cache()
    ref = zoo_first_loss_on_cpu(ZOO_R18_CFG)
    rel = abs(res["losses"][0] - ref) / abs(ref)
    log(f"[cnn torch_zoo resnet18] first loss card {res['losses'][0]} vs "
        f"CPU {ref} (relative {rel:.3e}, rtol {CNN_REF_RTOL}); median step "
        f"{res['median_step_s'] * 1e3:.2f} ms, {res['images_per_s']:.1f} "
        f"images/s, peak {res['peak_gib']:.2f} GiB, arm "
        f"{time.perf_counter() - t0:.1f} s on {card_line()}")
    if rel > CNN_REF_RTOL:
        raise AssertionError("cnn torch_zoo: ResNet-18 left the CPU's loss")
    t0 = time.perf_counter()
    zoo_card_vs_cpu_val(dev)
    out = async_run("easgd", [dev.index] * 2, ZOO_CNN_CFG, ZOO_CNN, tau=2,
                    verbose=False)
    wall = time.perf_counter() - t0
    losses, val = out["recorder"].train_losses, out["final_val"]
    line = {"losses": losses, "val": val, "exchanges": out["exchanges"],
            "iterations": out["iterations"], "epoch_s": out["epoch_times"],
            "arm_s": wall}
    log(f"[cnn torch_zoo cnn easgd] {json.dumps(line)} on {card_line()}")
    if not out["exchanges"] or out["iterations"] != ZOO_EASGD_STEPS \
            or not all(math.isfinite(x) for x in losses) \
            or not 0.0 <= val["err"] <= 1.0:
        raise AssertionError(f"cnn torch_zoo: EASGD x TorchCNN {out}")


def run_cnn_phase(dev) -> None:
    """The cnn phase (module docstring, item 6)."""
    import torch

    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group

    use_synthetic_data()
    check_cnn_reference(dev)

    # the group outlives the runs, so the profiles can take more steps
    init_group(dev)
    feeds = {}
    for feed, knobs in FEEDS.items():
        res, model = run_cnn(dev, f"resnet50 {feed}", RESNET50,
                             dict(RESNET50_CFG, **knobs))
        check_trajectory(f"cnn resnet50 {feed}", res, CNN_TRAJECTORY)
        res["profile"] = profile_feed(model, f"cnn resnet50 {feed}")
        if model._chunk_k:
            res["ab"] = chunk_ab(model, model._chunk_k)
            log(f"[cnn resnet50 {feed}] one step a call against "
                f"{model._chunk_k} a call, in turns: "
                f"{json.dumps(res['ab'])} on {card_line()}")
            check_no_host_traffic(f"cnn resnet50 {feed}",
                                  res["ab"]["chunk_traffic"])
        feeds[feed] = res
        if feed == "synchronous":
            # the momentum update alone (zero gradients, lr 0): its
            # device time is the optimizer's share, which kernel names
            # cannot separate from the other elementwise passes
            grads = [torch.zeros_like(p) for p in model.params]
            opt_ms = time_ms(lambda: model.optimizer.update(
                model.params, grads, model.opt_state, 0.0), reps=5,
                warmup=1)
            log(f"[cnn resnet50] momentum update alone: {opt_ms:.3f} ms "
                f"over {res['params_m']:.2f} M fp32 parameters on "
                f"{card_line()}")
            del grads
        del model
        torch.cuda.empty_cache()
    summary = {feed: {k: r[k] for k in ("median_step_s", "images_per_s",
                                        "median_wait_s", "median_calc_s",
                                        "loader", "profile")}
               for feed, r in feeds.items()}
    log(f"[cnn resnet50 feeds] {json.dumps(summary)} on {card_line()}")
    loader = feeds["pipelined"]["loader"]
    if loader is None or loader["staged"] + loader["starved"] != CNN_STEPS \
            or loader["starved"] > 1:
        raise AssertionError(f"cnn: pipelined feed delivered {loader}")
    sums = {feed: r["batch_checksums"] for feed, r in feeds.items()}
    if len({tuple(v) for v in sums.values()}) != 1:
        raise AssertionError(f"cnn: the feeds staged other batches: {sums}")
    log(f"[cnn resnet50 feeds] the {CNN_STEPS} staged batches are bitwise "
        f"equal across {list(FEEDS)}")
    chunk, cached = (feeds[f]["losses"]
                     for f in ("device_cache_chunk", "device_cache"))
    log(f"[cnn resnet50 feeds] device_cache_chunk losses {chunk} against "
        f"device_cache's {cached}: "
        f"{'bitwise equal' if chunk == cached else 'DIFFER'}")
    if chunk != cached:
        raise AssertionError("cnn: the chunked device-resident feed's "
                             "losses differ from the per-step one's")
    run_tmb_feeds(dev, feeds["device_cache"])

    _, model = run_cnn(dev, "alexnet", ALEXNET, ALEXNET_CFG)
    del model
    torch.cuda.empty_cache()
    for name, spec, cfg, want in (
            ("vgg16", VGG16, VGG16_CFG, VGG16_TRAJECTORY),
            ("googlenet", GOOGLENET, GOOGLENET_CFG, GOOGLENET_TRAJECTORY)):
        res, model = run_cnn(dev, name, spec, cfg)
        check_trajectory(f"cnn {name}", res, want)
        res["profile"] = profile_feed(model, f"cnn {name}")
        log(f"[cnn {name}] profile {json.dumps(res['profile'])}")
        del model
        torch.cuda.empty_cache()
    destroy_group()
    torch.cuda.empty_cache()
    run_zoo_arm(dev)


# -- the asynchronous rules (BASELINE.json configs 3 and 4) -------------------

LSTM_SPEC = dict(modelfile="theanompi_tpu_torch.models.lstm",
                 modelclass="LSTM")
ASYNC_STEPS, ASYNC_VAL_BATCHES, ASYNC_W = 8, 2, 4
# config 4: GoSGD x the IMDB LSTM at the JAX defaults (the published
# width), 32 reviews a worker
LSTM_BATCH = 32
LSTM_GOSGD_CFG = dict(vocab=10000, emb_dim=128, hidden=128, maxlen=100,
                      batch_size=LSTM_BATCH, dropout=0.5,
                      compute_dtype="bfloat16", lr=0.1, weight_decay=0.0,
                      n_train=ASYNC_STEPS * ASYNC_W * LSTM_BATCH,
                      n_val=ASYNC_VAL_BATCHES * ASYNC_W * LSTM_BATCH, seed=0)
GOSGD_KW = dict(push_prob=0.25)
# config 3: EASGD x ResNet-50 at its published config (the cnn phase's),
# 128 images a worker, alpha 1/W, tau 4: two center merges in 8 steps
RESNET50_EASGD_CFG = dict(RESNET50_CFG,
                          n_train=ASYNC_STEPS * ASYNC_W * CNN_BATCH,
                          n_val=ASYNC_VAL_BATCHES * ASYNC_W * CNN_BATCH)
EASGD_KW = dict(alpha=1.0 / ASYNC_W, tau=4)
# first and last training loss and the val loss of both runs (seed 0,
# synthetic data), as the first run of the async phase gave them on an
# H100: later runs must stay within CNN_TRAJECTORY_RTOL (bf16 products;
# the embedding's backward accumulates with atomics)
LSTM_GOSGD_TRAJECTORY = {"first": 0.693033, "last": 0.681746,
                         "val": 0.697183}
RESNET50_EASGD_TRAJECTORY = {"first": 6.91676, "last": 7.13119,
                             "val": 6.98087}
# the card-vs-CPU checks of both rules: fp32, dropout 0, per-step losses,
# val loss and GoSGD's final scores differ by summation order only,
# carried over 4 steps and the merges
ASYNC_REF_RTOL = 1e-4
ASYNC_SMALL = {
    "gosgd lstm": ("gosgd", LSTM_SPEC,
                   dict(vocab=64, emb_dim=16, hidden=16, maxlen=20,
                        batch_size=8, n_train=64, n_val=16, dropout=0.0,
                        compute_dtype="float32", seed=3),
                   dict(push_prob=0.5, staleness=1)),
    "easgd wresnet": ("easgd", WRESNET,
                      dict(CNN_SMALL, batch_size=4, n_train=32, n_val=8,
                           lr_schedule=None),
                      dict(tau=2, speeds=[1.0, 0.5])),
}


def async_run(rule: str, devices, config, model, **kw) -> dict:
    """One in-process run of ``rule`` ("easgd" or "gosgd") through the
    rule API; its summary."""
    from theanompi_tpu_torch import EASGD, GOSGD

    r = {"easgd": EASGD, "gosgd": GOSGD}[rule]()
    r.init(devices=devices, launch="inprocess", config=config, n_epochs=1,
           **model, **kw)
    return r.wait()


def check_async_reference(dev) -> None:
    """A tiny fp32 LSTM under GoSGD (W = 2, staleness 1) and WResNet-10-1
    under EASGD (W = 2, ``speeds`` set: BN state per replica), each
    trained 4 steps with both replicas on the card and on the CPU from
    one init checkpoint: losses, val loss and GoSGD's scores must agree
    within ``ASYNC_REF_RTOL``."""
    import importlib

    import numpy as np

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, (rule, spec, cfg, kw) in ASYNC_SMALL.items():
            cls = getattr(importlib.import_module(spec["modelfile"]),
                          spec["modelclass"])
            init = Path(tmp) / name / "init"
            cls.save_init_checkpoint(cfg, init)
            got = []
            for where, devices in (("card", [dev.index] * 2),
                                   ("cpu", ["cpu"] * 2)):
                d = Path(tmp) / name / where
                shutil.copytree(init, d)
                out = async_run(rule, devices, cfg, spec,
                                checkpoint_dir=str(d), resume=True,
                                verbose=False, **kw)
                got.append({"losses": out["recorder"].train_losses,
                            "val": out["final_val"]["loss"],
                            "scores": out.get("scores")})
            card, cpu = got
            ok = len(card["losses"]) == 4 and all(
                np.allclose(card[k], cpu[k], rtol=ASYNC_REF_RTOL, atol=0)
                for k in ("losses", "val")
                + (("scores",) if rule == "gosgd" else ()))
            log(f"reference [async] {name} fp32, W=2, {kw}: card {card} vs "
                f"CPU {cpu} (rtol {ASYNC_REF_RTOL}): "
                f"{'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"async: {name} card and CPU differ")


def run_async(dev, name: str, rule: str, model: dict, cfg: dict, kw: dict,
              unit: str, want) -> tuple[dict, object]:
    """One epoch of ``rule`` x ``model`` with ``ASYNC_W`` replicas on the
    card: each iteration (wait + the W replica steps + any exchange)
    timed from one printed step to the next with the device
    synchronized, its Recorder segments read alike; then the val
    batches.  Losses finite, val numbers in range, exchanges made, and
    the losses held to ``want``.  Returns (numbers, the run's replica
    engine)."""
    import torch

    from theanompi_tpu_torch.utils.recorder import Recorder
    from theanompi_tpu_torch.workers.replica_engine import ReplicaEngine

    marks, engines = [], []
    print_info, init = Recorder.print_train_info, ReplicaEngine.__init__

    def mark(self, count):
        print_info(self, count)
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), dict(self.total_segments)))

    def keep(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)

    torch.cuda.reset_peak_memory_stats()
    Recorder.print_train_info, ReplicaEngine.__init__ = mark, keep
    try:
        out = async_run(rule, [dev.index] * ASYNC_W, cfg, model,
                        print_freq=1, **kw)
    finally:
        Recorder.print_train_info, ReplicaEngine.__init__ = print_info, init
    (engine,) = engines
    losses, val = out["recorder"].train_losses, out["final_val"]
    steps = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    segs = [{k: b[1][k] - a[1][k] for k in ("wait", "calc", "comm")}
            for a, b in zip(marks, marks[1:])]
    med = statistics.median(steps)
    gb = engine.model.data.global_batch
    res = {
        "run": name, "config": cfg, "rule_kwargs": kw,
        "n_workers": out["n_workers"], "global_batch": gb,
        "params_m": sum(p.numel() for p in engine.model.params) / 1e6,
        "losses": losses, "val": val, "step_s": steps,
        "median_step_s": med, f"{unit}_per_s": gb / med,
        **{f"median_{k}_s": statistics.median(s[k] for s in segs)
           for k in ("wait", "calc", "comm")},
        "total_segments_s": dict(out["recorder"].total_segments),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if rule == "gosgd":
        res.update(gossip_rounds=out["gossip_rounds"], scores=out["scores"],
                   best_worker=out["best_worker"])
    else:
        res["center_merges"] = out["exchanges"] // out["n_workers"]
    n_exch = res.get("gossip_rounds", res.get("center_merges"))
    res["comm_s_per_exchange"] = (res["total_segments_s"]["comm"] / n_exch
                                  if n_exch else None)
    log(f"[async {name}] {json.dumps(res)} on {card_line()}")
    if len(losses) != ASYNC_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"async {name}: losses {losses}")
    if not (math.isfinite(val["loss"])
            and 0.0 <= val["err_top5"] <= val["err"] <= 1.0):
        raise AssertionError(f"async {name}: val {val}")
    if not n_exch:
        raise AssertionError(f"async {name}: no exchange")
    if rule == "easgd" and res["center_merges"] != ASYNC_STEPS // kw["tau"]:
        raise AssertionError(f"async {name}: {res['center_merges']} merges")
    check_trajectory(f"async {name}", res, want)
    return res, engine


def profile_engine(engine, name: str, steps: int = 2) -> dict:
    """``profile_step`` over ``steps`` more training steps of the run's
    replica engine (each the W replica steps on a staged batch); the
    busy share and the wall and device time a step."""
    data, lr = engine.model.data, engine.model.current_lr
    prof = profile_step(
        lambda i: engine.train_step(data.train_batch(i % data.n_batch_train),
                                    lr), steps, f"async {name}")
    return {k: prof[k] for k in ("busy_share", "wall_ms_per_step",
                                 "device_ms_per_step")}


def run_async_phase(dev, counters) -> None:
    """The async phase (module docstring, item 7)."""
    import torch

    use_synthetic_data()
    reset_counts(*counters)
    check_async_reference(dev)
    summary = {}
    for name, rule, model, cfg, kw, unit, want in (
            ("gosgd lstm", "gosgd", LSTM_SPEC, LSTM_GOSGD_CFG, GOSGD_KW,
             "reviews", LSTM_GOSGD_TRAJECTORY),
            ("easgd resnet50", "easgd", RESNET50, RESNET50_EASGD_CFG,
             EASGD_KW, "images", RESNET50_EASGD_TRAJECTORY)):
        res, engine = run_async(dev, name, rule, model, cfg, kw, unit, want)
        res["profile"] = profile_engine(engine, name)
        summary[name] = {k: v for k, v in res.items()
                         if k.startswith(("median_", "peak_", "gossip",
                                          "center", "comm_", "profile"))
                         or k.endswith("_per_s")}
        del engine
        torch.cuda.empty_cache()
    log(f"[async] {json.dumps(summary)} on {card_line()}")
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"[async] launches of the package's kernels over the phase: "
        f"{launches} (no kernel of the package lies on this path)")


# -- the async rules across processes (BASELINE.json configs 3 and 4) -------

DIST_W = 4
# card against CPU: EASGD's _run_distributed in one process (a world of
# one, the center on 127.0.0.1, alpha 0.5, tau 2) on a tiny fp32 LSTM,
# dropout 0, from one init checkpoint: the one multi-process path whose
# result is deterministic.  fp32 summation order only, over 8 steps and
# 4 exchanges (the in-process LSTM check measured 1.8e-7)
DIST_REF_RTOL = 1e-6
DIST_SMALL = dict(vocab=64, emb_dim=16, hidden=16, maxlen=20, batch_size=8,
                  n_train=64, n_val=16, dropout=0.0, compute_dtype="float32",
                  seed=3)
# config 3: EASGD x ResNet-50 at the async phase's configuration, one
# worker a process (batch 128 each), alpha 1/4, tau 4: 2 exchanges a
# process in 8 steps
DIST_RESNET50_CFG = dict(RESNET50_CFG, n_train=ASYNC_STEPS * CNN_BATCH,
                         n_val=ASYNC_VAL_BATCHES * CNN_BATCH)
DIST_EASGD_KW = dict(alpha=1.0 / DIST_W, tau=4)
# config 4: GoSGD x the IMDB LSTM at the JAX defaults, 32 reviews a
# process, push probability 0.25, a checkpoint_dir so the per-epoch
# best-score election runs
DIST_LSTM_CFG = dict(LSTM_GOSGD_CFG, n_train=ASYNC_STEPS * LSTM_BATCH,
                     n_val=ASYNC_VAL_BATCHES * LSTM_BATCH)
DIST_GOSGD_KW = dict(push_prob=0.25)
DIST_CHILD_TIMEOUT_S = 600


def check_dist_reference(dev) -> None:
    """EASGD's ``_run_distributed`` in one process on the card and on the
    CPU from one init checkpoint: per-step losses and the center's val
    loss within ``DIST_REF_RTOL``."""
    import socket

    import numpy as np

    from theanompi_tpu_torch.models.lstm import LSTM
    from theanompi_tpu_torch.workers import easgd_worker

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        init = Path(tmp) / "init"
        LSTM.save_init_checkpoint(DIST_SMALL, init)
        got = []
        for where, device in (("card", dev), ("cpu", "cpu")):
            d = Path(tmp) / where
            shutil.copytree(init, d)
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            out = easgd_worker._run_distributed(
                devices=[device], rank=0, world_size=1, init_method=None,
                config=dict(DIST_SMALL), alpha=0.5, tau=2, n_epochs=1,
                checkpoint_dir=str(d), resume=True, print_freq=40,
                verbose=False, center_addr=f"127.0.0.1:{port}",
                **LSTM_SPEC)
            got.append({"losses": out["recorder"].train_losses,
                        "center_val": out["center_val"]["loss"],
                        "exchanges": out["exchanges"]})
        card, cpu = got
        ok = (len(card["losses"]) == 8 and card["exchanges"] == 4
              and card["exchanges"] == cpu["exchanges"]
              and all(np.allclose(card[k], cpu[k], rtol=DIST_REF_RTOL, atol=0)
                      for k in ("losses", "center_val")))
        log(f"reference [async_dist] easgd lstm fp32, one process, alpha "
            f"0.5, tau 2: card {card} vs CPU {cpu} (rtol {DIST_REF_RTOL}): "
            f"{'equal' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError("async_dist: card and CPU differ")


def spawn_dist(dev, name: str, rule: str, model: dict, kwargs: dict,
               tmp: Path) -> list[dict]:
    """``DIST_W`` processes of one run, each started through the port's
    CLI (``--coordinator 127.0.0.1:<port> --num-hosts W --host-id i
    --devices <card>``); their summaries.  A child that exits non-zero,
    or outlives ``DIST_CHILD_TIMEOUT_S``, fails the run; none is left
    running."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    device = "cpu" if dev.type == "cpu" else str(dev.index)
    procs, logs = [], []
    try:
        for r in range(DIST_W):
            logs.append(open(tmp / f"{rule}{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "theanompi_tpu_torch.launcher",
                 rule.upper(), model["modelfile"], model["modelclass"],
                 "--devices", device, "--coordinator",
                 f"127.0.0.1:{port}", "--num-hosts", str(DIST_W),
                 "--host-id", str(r), "--kwargs", json.dumps(kwargs),
                 "--summary-json", str(tmp / f"{rule}{r}.json")],
                env=env, cwd=str(ROOT), stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DIST_CHILD_TIMEOUT_S
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        for r, rc in enumerate(rcs):
            if rc:
                tail = (tmp / f"{rule}{r}.log").read_text()[-3000:]
                log(f"[async_dist {name}] process {r} exited {rc}:\n{tail}")
        raise AssertionError(f"async_dist {name}: exit codes {rcs}")
    return [json.loads((tmp / f"{rule}{r}.json").read_text())
            for r in range(DIST_W)]


def dist_numbers(outs: list[dict], unit: str, batch: int) -> dict:
    """Each process's median iteration (from its recorder's per-iteration
    window marks, every one fenced: iterations 2-8), rate, comm and
    bytes, and the aggregate rate: every process's iterations 2-8 over
    the span from the first of them to start to the last to end (the
    marks are the host's monotonic clock, one for all processes)."""
    per, n_iters, first, last = [], 0, [], []
    for o in outs:
        marks = [t for _, t in o["window_marks"]]
        steps = [b - a for a, b in zip(marks, marks[1:])]
        med = statistics.median(steps)
        n_iters += len(steps)
        first.append(marks[0])
        last.append(marks[-1])
        n_exch = o.get("exchanges", o.get("pushes"))
        comm = o["total_segments"]["comm"]
        row = {
            "process": o["process_index"], "median_iteration_ms": med * 1e3,
            f"{unit}_per_s": batch / med, "comm_ms": comm * 1e3,
            "bytes_sent": o["bytes_sent"],
            "bytes_received": o["bytes_received"],
            "peak_gib": o["peak_device_bytes"] / 2**30
            if "peak_device_bytes" in o else None,
            "losses": o["train_losses"], "val": o["final_val"],
        }
        if "exchanges" in o:
            row.update(
                exchanges=n_exch,
                comm_ms_per_exchange=comm * 1e3 / n_exch if n_exch else None,
                bytes_sent_per_exchange=o["bytes_sent"] / n_exch
                if n_exch else None,
                bytes_received_per_exchange=o["bytes_received"] / n_exch
                if n_exch else None)
        else:
            row.update({k: o[k] for k in ("pushes", "delivered", "merges",
                                          "score", "mid_saves")})
        per.append(row)
    return {"processes": per,
            f"aggregate_{unit}_per_s": n_iters * batch
            / (max(last) - min(first)),
            f"sum_of_process_{unit}_per_s": sum(r[f"{unit}_per_s"]
                                                for r in per)}


def check_dist_run(name: str, outs: list[dict]) -> None:
    """Every process trained ``ASYNC_STEPS`` finite losses and scored
    its val batches."""
    for o in outs:
        losses = o["train_losses"]
        if len(losses) != ASYNC_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"async_dist {name}: losses {losses}")
        if len(o["window_marks"]) != ASYNC_STEPS:
            raise AssertionError(f"async_dist {name}: marks "
                                 f"{o['window_marks']}")
        if not math.isfinite(o["final_val"]["loss"]):
            raise AssertionError(f"async_dist {name}: val {o['final_val']}")


def time_exchange_alone(dev, reps: int = 3, wires=(None,)) -> dict:
    """One EASGD exchange of ResNet-50's parameters (the phase's
    config) with nothing else running, on each TCP wire of ``wires``
    (None: fp32; a dtype or a codec of ``WIRE_CODECS``): the center
    server and the client in this process on 127.0.0.1, the parameters
    on the card.  Medians over ``reps`` of: the parameters to the host,
    the client's exchange (encode, send, the server's decode and axpy,
    the reply, the local update), the server's lock hold, and the copy
    back into the parameter tensors; the bytes each way.  Returns
    ``{wire name: numbers}`` and, under ``leaves_host``, the last host
    copy of the parameters."""
    import importlib

    import torch

    from theanompi_tpu_torch.parallel.center_server import (
        EASGDCenterClient,
        EASGDCenterServer,
        _to_host,
    )
    from theanompi_tpu_torch.workers.replica_engine import load_leaves

    cls = getattr(importlib.import_module(RESNET50["modelfile"]),
                  RESNET50["modelclass"])
    model = cls(dict(DIST_RESNET50_CFG, n_train=CNN_BATCH, n_val=CNN_BATCH),
                device=dev)
    model.build_model()
    params = model.params
    out = {}
    for wire in wires:
        server = EASGDCenterServer(params, DIST_EASGD_KW["alpha"],
                                   host="127.0.0.1")
        client = EASGDCenterClient(server.address, wire=wire)
        times = {"to_host": [], "exchange": [], "hold": [], "to_card": []}
        try:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host = _to_host(params)
                t1 = time.perf_counter()
                held = server.stats()["mean_hold_s"] * server.exchanges
                new = client.exchange(host, DIST_EASGD_KW["alpha"])
                t2 = time.perf_counter()
                times["hold"].append(server.stats()["mean_hold_s"]
                                     * server.exchanges - held)
                load_leaves(params, new)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                times["to_host"].append(t1 - t0)
                times["exchange"].append(t2 - t1)
                times["to_card"].append(t3 - t2)
            out[wire or "fp32"] = {
                "bytes_each_way": client.bytes_sent // reps,
                "bytes_back": client.bytes_received // reps,
                "leaves": len(host),
                **{f"{k}_ms": statistics.median(v) * 1e3
                   for k, v in times.items()}}
        finally:
            client.close()
            server.stop()
    out["leaves_host"] = host
    del model, params
    torch.cuda.empty_cache()
    return out


def run_async_dist_phase(dev) -> None:
    """The async_dist phase (module docstring, item 8)."""
    use_synthetic_data()
    check_dist_reference(dev)
    alone = time_exchange_alone(dev)["fp32"]
    log(f"[async_dist] one ResNet-50 exchange alone (server and client in "
        f"this process, fp32 wire): {json.dumps(alone)} on {card_line()}")
    summary = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # config 3: EASGD x ResNet-50, DIST_W processes on the card
        kw = dict(config=DIST_RESNET50_CFG, n_epochs=1, print_freq=1,
                  verbose=False, **DIST_EASGD_KW)
        t0 = time.perf_counter()
        outs = spawn_dist(dev, "easgd resnet50", "easgd", RESNET50, kw, tmp)
        wall = time.perf_counter() - t0
        check_dist_run("easgd resnet50", outs)
        per_proc = ASYNC_STEPS // DIST_EASGD_KW["tau"]
        if [o["exchanges"] for o in outs] != [per_proc] * DIST_W:
            raise AssertionError(f"async_dist easgd: exchanges "
                                 f"{[o['exchanges'] for o in outs]}")
        stats, center_val = outs[0]["center_stats"], outs[0]["center_val"]
        if stats["exchanges"] != per_proc * DIST_W \
                or stats["stopped_workers"] != DIST_W:
            raise AssertionError(f"async_dist easgd: center {stats}")
        if any(o["center_val"] for o in outs[1:]) or not (
                center_val and math.isfinite(center_val["loss"])):
            raise AssertionError(f"async_dist easgd: center val "
                                 f"{[o['center_val'] for o in outs]}")
        res = dist_numbers(outs, "images", CNN_BATCH)
        res.update(center_stats=stats, center_val=center_val,
                   wall_s_with_start=wall)
        log(f"[async_dist easgd resnet50] {json.dumps(res)} on "
            f"{card_line()}")
        summary["easgd resnet50"] = res

        # config 4: GoSGD x the IMDB LSTM, DIST_W processes on the card
        ckpt = tmp / "gosgd_ckpt"
        ckpt.mkdir()
        kw = dict(config=DIST_LSTM_CFG, n_epochs=1, print_freq=1,
                  verbose=False, checkpoint_dir=str(ckpt), **DIST_GOSGD_KW)
        t0 = time.perf_counter()
        outs = spawn_dist(dev, "gosgd lstm", "gosgd", LSTM_SPEC, kw, tmp)
        wall = time.perf_counter() - t0
        check_dist_run("gosgd lstm", outs)
        total = sum(o["score"] for o in outs)
        delivered = sum(o["delivered"] for o in outs)
        merges = sum(o["merges"] for o in outs)
        savers = [o["process_index"] for o in outs if o["mid_saves"]]
        best = max(range(DIST_W), key=lambda p: outs[p]["epoch_scores"][0])
        log(f"[async_dist gosgd lstm] scores sum {total!r}, delivered "
            f"{delivered}, merged {merges}, epoch-0 savers {savers} (best "
            f"published score: process {best})")
        if abs(total - 1.0) > 1e-5 or merges != delivered \
                or savers != [best]:
            raise AssertionError("async_dist gosgd: an invariant broke")
        res = dist_numbers(outs, "reviews", LSTM_BATCH)
        res.update(scores_sum=total, wall_s_with_start=wall)
        log(f"[async_dist gosgd lstm] {json.dumps(res)} on {card_line()}")
        summary["gosgd lstm"] = res
    log(f"[async_dist] " + json.dumps({
        k: {m: v for m, v in r.items() if m.startswith(("aggregate",
                                                         "sum_of"))}
        for k, r in summary.items()}) + f" on {card_line()}")


# -- phase 1: what the compiler made of the kernels -------------------------

# -- exchange: zero1, the compressed wire, .shards, the TCP codec ------------

EXCH_RANKS = 2
EXCH_LAYERS = 2          # depth of the two-rank arm's models (REDUCED)
EXCH_STEPS = 2
EXCH_REQUESTS = 8
EXCH_TOKENS = 16
# the int8 wire with error feedback against the fp32 allreduce: the JAX
# package's convergence test's tolerance
# (tests/test_compression.py::test_int8_ef_tracks_fp32)
EXCH_INT8_RTOL = 1e-2
EXCH_CHILD_TIMEOUT_S = 600
#: the training phase's ici32 run, for the exchange phase to compare
TRAINED: dict = {}


def exchange_config(n_layers: int, ranks: int, **extra) -> dict:
    """The two-rank arm's Llama: the training phase's config at
    ``n_layers``, batch 2 a rank, ``EXCH_STEPS`` steps."""
    from theanompi_tpu_torch.models import LLAMA3_8B

    cfg = dict(LLAMA3_8B, n_layers=n_layers, seq_len=2048, batch_size=2,
               n_train=EXCH_STEPS * 2 * ranks, n_val=2 * ranks,
               compute_dtype="bfloat16", optimizer="adam", lr=1e-4,
               remat=True, xent_chunks="auto", seed=0,
               exch_strategy="zero1", exch_compression="fp8",
               error_feedback=False)
    cfg.update(extra)
    return cfg


def exchange_rank(dev, rank: int, init: str, ckpt_dir: str) -> None:
    """One rank of the exchange phase's two-rank arm (``--exchange-rank
    r``): a gloo group on card 0, the model trained ``EXCH_STEPS`` steps
    under zero1 on the fp8 wire, then saved; its numbers as the last
    line of standard output."""
    import torch

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
    from theanompi_tpu_torch.utils import Recorder

    init_group(dev, rank, EXCH_RANKS, init, backend="gloo")
    try:
        model = Llama(exchange_config(EXCH_LAYERS, EXCH_RANKS), device=dev)
        model.build_model(n_replicas=EXCH_RANKS)
        model.compile_iter_fns()
        rec = Recorder(rank=rank, size=EXCH_RANKS, verbose=False)
        times = []
        for i in range(EXCH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.train_iter(i, rec)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        model.epoch = 0
        t0 = time.perf_counter()
        model.save(ckpt_dir, rec)
        save_s = time.perf_counter() - t0
        print(json.dumps({
            "rank": rank, "losses": rec.train_losses, "step_s": times,
            "save_s": save_s, "zero1_layout": model._zero1_layout,
            "ef_layout": model._ef_layout, "size": model._fspec.size,
            "shard_len": model._fspec.shard_len,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}),
            flush=True)
    finally:
        destroy_group()


def exchange_two_ranks(dev, ckpt: Path) -> list[dict]:
    """Start both ranks of the two-rank arm (``--exchange-rank``) and
    return their numbers, rank order."""
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--exchange-rank",
         str(r), "--exchange-init", init, "--exchange-dir", str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(EXCH_RANKS)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=EXCH_CHILD_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"exchange: rank {r} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def digests_on_host(arrays: dict) -> dict:
    """``{key: [crc32 of each tensor]}`` (``array_digest``), each copied
    to the host and hashed in a thread (zlib drops the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from theanompi_tpu_torch.utils.checkpoint import array_digest

    def one(t):
        return array_digest(t.contiguous().cpu().numpy())

    items = [(k, t) for k, ts in arrays.items() for t in ts]
    out = {k: [] for k in arrays}
    with ThreadPoolExecutor(8) as ex:
        for (k, _), crc in zip(items, ex.map(one, [t for _, t in items])):
            out[k].append(crc)
    return out


def shard_digests(path: Path, key: str) -> dict:
    """``{(start, stop): crc32}`` of a ``.shards`` leaf's shard files, as
    the ranks stamped them when they wrote their own shards."""
    out = {}
    for frag in sorted(path.glob("index.p*.json")):
        entry = json.loads(frag.read_text()).get(key)
        for sh in (entry or {}).get("shards", []):
            out[tuple(sh["index"][0]) if sh["index"] else ()] = sh["digest"]
    return out


def exchange_shards_arm(dev, records: dict) -> dict:
    """Two ranks on card 0 over gloo, full width, ``EXCH_LAYERS`` deep:
    zero1 on the fp8 wire (no residual: REDUCED) for ``EXCH_STEPS`` steps,
    saved as ``.shards`` (verified); resumed at one rank with
    ``load(reshard=True)``, whose parameters and gathered m/v are the
    two ranks' bitwise (their crc32s against the digests each rank
    stamped at save); then a paged decoder from the ``.shards``
    directory serving ``EXCH_REQUESTS`` greedy requests with a decoder's
    ids over the same parameters in memory, K4's launches counted."""
    import torch

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.parallel.exchange import tree_map
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
    from theanompi_tpu_torch.serving import decoder_from_checkpoint
    from theanompi_tpu_torch.serving.paged_attention import paged_attend_cuda
    from theanompi_tpu_torch.utils.checkpoint import flatten
    from theanompi_tpu_torch.utils.sharded_checkpoint import (
        is_sharded_checkpoint,
        verify_sharded_checkpoint,
    )

    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ckpt = Path(tmp) / "ckpt"
        t0 = time.perf_counter()
        ranks = exchange_two_ranks(dev, ckpt)
        out["two_ranks_s"] = time.perf_counter() - t0
        out["ranks"] = ranks
        path = ckpt / "ckpt_0.shards"
        t0 = time.perf_counter()
        ok = is_sharded_checkpoint(path) and verify_sharded_checkpoint(path)
        out["verify_s"] = time.perf_counter() - t0
        out["checkpoint_gib"] = sum(f.stat().st_size for f in
                                    path.iterdir()) / 2**30
        if not ok or [p.name for p in ckpt.iterdir()] != [path.name]:
            raise AssertionError(f"exchange: {list(ckpt.iterdir())} is not "
                                 f"one verified .shards checkpoint")
        if ranks[0]["losses"] != ranks[1]["losses"]:
            raise AssertionError(f"exchange: the ranks' losses differ: "
                                 f"{[r['losses'] for r in ranks]}")
        (padded, bl), size = ranks[0]["zero1_layout"], ranks[0]["size"]
        init_group(dev)
        try:
            cfg = exchange_config(EXCH_LAYERS, 1, batch_size=4)
            model = Llama(cfg, device=dev)
            model.build_model()
            model.compile_iter_fns()
            t0 = time.perf_counter()
            if not model.load(ckpt, reshard=True):
                raise AssertionError("exchange: nothing to resume")
            out["resume_s"] = time.perf_counter() - t0
            if model.resharded_from != {"world_size": 2,
                                        "groups": ["opt_state"]}:
                raise AssertionError(f"exchange: resharded "
                                     f"{model.resharded_from}")
            # the parameters: each leaf's crc32 = the digest rank 0
            # wrote; m and v: this rank's pack order laid out as the two
            # ranks held it (on the card: at one rank the storage IS the
            # pack order), each half's crc32 = the digest its rank wrote
            p1, bl1 = model._zero1_layout
            nb = padded // bl if bl else 1
            want, arrays = {}, {}
            for key, t in flatten(model.params).items():
                want[f"params:{key}"] = list(shard_digests(
                    path, f"params:{key}").values())
                arrays[f"params:{key}"] = [t.detach()]
            for name in ("m", "v"):
                t = model.opt_state[name][0]
                buf = torch.zeros(padded, dtype=t.dtype, device=t.device)
                buf[:size] = t[:size]
                st = buf.view(nb, EXCH_RANKS, -1).transpose(0, 1) \
                    .reshape(EXCH_RANKS, -1)
                key = f"opt_state:['{name}']"
                want[key] = [d for _, d in sorted(
                    shard_digests(path, key).items())]
                arrays[key] = list(st)
            crcs = digests_on_host(arrays)
            bad = [k for k in want if crcs[k] != want[k]]
            out["bitwise"] = not bad
            log(f"[exchange shards] two ranks -> one: params and gathered "
                f"m/v {'bitwise' if not bad else 'DIFFER at ' + str(bad)} "
                f"(layouts {ranks[0]['zero1_layout']} -> "
                f"{list(model._zero1_layout)})")
            if bad:
                raise AssertionError(f"exchange: resumed state differs at "
                                     f"{bad}")
            serve_cfg = dict(cfg, compute_dtype="bfloat16")
            mem = Llama(serve_cfg, device=dev, params=tree_map(
                lambda t: t.detach().to(torch.bfloat16), model.params))
            del model
            torch.cuda.empty_cache()
            vocab = mem.vocab
            prompts = [p[:64] for p in make_requests(vocab)[0][:EXCH_REQUESTS]]
            want_ids = serve(mem.make_decoder(paged=True, **FLEET_KW),
                             prompts, max_tokens=EXCH_TOKENS,
                             seeds=list(range(len(prompts))),
                             prefix_caching=False)[0]
            del mem
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            dec = decoder_from_checkpoint(serve_cfg, str(ckpt), device=dev,
                                          paged=True, **FLEET_KW)
            out["decoder_from_shards_s"] = time.perf_counter() - t0
            reset_counts(paged_attend_cuda)
            got_ids = serve(dec, prompts, max_tokens=EXCH_TOKENS,
                            seeds=list(range(len(prompts))),
                            prefix_caching=False)[0]
            k4 = paged_attend_cuda.launches
            del dec
            torch.cuda.empty_cache()
        finally:
            destroy_group()
    same = sum(a == b for a, b in zip(want_ids, got_ids))
    out["served"] = {"requests_equal": f"{same} of {len(prompts)}",
                     "k4_launches": k4}
    log(f"[exchange shards] served from .shards vs in memory: "
        f"{same} of {len(prompts)} requests equal, K4 launches {k4}")
    if same != len(prompts) or not k4:
        raise AssertionError("exchange: ids served from the .shards "
                             "checkpoint differ, or K4 never launched")
    add_launches(records.setdefault("K4", {}), exchange_shards_serving=k4)
    return out


def exchange_tcp_arm(dev) -> dict:
    """One ResNet-50 exchange alone on the fp32, int8 and fp8 TCP wires
    (``time_exchange_alone``), then the codec's identity on those
    parameters: the center decodes exactly what the sender decodes
    locally (the error-feedback residual rests on it)."""
    import socket

    from theanompi_tpu_torch.parallel import center_server as cs

    res = time_exchange_alone(dev, wires=(None, "int8", "fp8"))
    host = res.pop("leaves_host")
    for wire in ("int8", "fp8"):
        arrs, orig, scales = cs.wire_cast(host, wire)
        a, b = socket.socketpair()
        with a, b:
            sender = threading.Thread(
                target=cs._send_arrays, args=(a, arrs, orig, scales))
            sender.start()
            _tag, header = cs._recv(b)
            got, _ = cs._recv_arrays_body(b, header)
            sender.join()
        same = all(
            (g.tobytes() == cs.dequantize_leaf(w, sc).tobytes())
            if sc is not None else True
            for g, w, sc in zip(got, arrs, scales))
        res[wire]["center_decode_equals_sender_decode"] = same
        if not same:
            raise AssertionError(f"exchange: the {wire} decode differs "
                                 f"between the sender and the center")
    fp32 = res["fp32"]["bytes_each_way"]
    for wire in ("int8", "fp8"):
        res[wire]["bytes_vs_fp32"] = res[wire]["bytes_each_way"] / fp32
    log(f"[exchange tcp] one ResNet-50 exchange alone by wire: "
        f"{json.dumps(res)} on {card_line()}")
    return res


# the layout arms: zero1, the compressed wire, .shards and the elastic
# resume at tp·sp·pp > 1, as four (and two) ranks on card 0 over gloo,
# through the parallel_train phase's children
XL_STEPS = 2             # full-width steps an exchange (REDUCED)
#: the full-width layout: tp = 2 x data = 2 at four ranks
XL_WIDE = dict(tp=2)
#: the small fp32 layouts, each over two data replicas at four ranks
XL_SMALL = {"tp2x2": dict(tp=2), "pp2x2": dict(pp=2),
            "ring2x2": dict(sp=2, sp_mode="ring")}
XL_ZERO1 = dict(exch_strategy="zero1")
XL_INT8 = dict(exch_compression="int8")
#: the small fp32 arms' zero1 against ici32: the sums are the same, but
#: at sp = 2 x data = 2 ici32 means over data x seq in one sum of four
#: and zero1 over seq, then over data, and Adam on a flat shard may take
#: another vector/tail split (fused multiply-adds) than on each tensor
#: (the host's kernels do: 7.6e-8 at tp = 2 x data = 2 on the CPU);
#: whether each arm came out bitwise is printed
XL_RTOL = 1e-5
#: the JAX reshard's refusal of a tp/pp-spanning flat state
XL_SPANNING = "spanning model/pipe axes (tp/pp-sharded zero1 packs)"


def xl_small(**kw) -> dict:
    """A layout arm's small fp32 model: Adam (zero1 shards its moments),
    batch 2 a replica, 4 steps an epoch over two replicas, no val."""
    return dict(dict(SMALL, optimizer="adam", lr=1e-2, remat=True,
                     batch_size=2, n_train=16, n_val=0,
                     exch_strategy="ici32"), **kw)


def xl_wide(**kw) -> dict:
    """The full-width layout arm: parallel_train's Llama-3-8B widths
    (``PT_LAYERS`` deep, seq ``PT_SEQ``, bf16, Adam, remat) at tp = 2 x
    data = 2, batch 1 a replica, ``XL_STEPS`` steps."""
    return dict(pt_config("bfloat16", **XL_WIDE), n_train=2 * XL_STEPS,
                **kw)


def exchange_layout_arm(dev, records: dict) -> dict:
    """zero1, the int8 wire with error feedback, their ``.shards``
    checkpoint and the elastic resume at layouts (four ranks on card 0
    over gloo, then two), through ``bsp_worker.run``:

    - full width, tp = 2 x data = 2 under ``ici32`` and zero1: losses
      bitwise on every rank, K1/K2/K3 at 2L/L/L a step on the tensor
      cores and no plain version; each rank's peak GiB, step ms and the
      exchange's reduce-scatter, all-gather and all-reduce ms;
    - small fp32: zero1 against ``ici32`` at tp = 2, pp = 2 and sp = 2
      (ring), each x data = 2, within ``XL_RTOL`` (bitwise printed); the
      int8 wire with error feedback at tp = 2 x data = 2 within
      ``EXCH_INT8_RTOL``; zero1 + int8 saved as ``.shards`` after epoch
      0 and resumed for epoch 1, bitwise a two-epoch run; an ``ici32``
      checkpoint (SGD at lr 0.5, which a wrongly sized batch moves)
      resumed elastically at tp = 2 x data = 1 (two ranks, the "global"
      policy) on the card and, from the same checkpoint, on the CPU,
      within ``TRAIN_REF_RTOL``; the zero1 + int8 checkpoint
      resumed at tp = 1 x data = 2, refused with the JAX reshard's
      words."""
    from theanompi_tpu_torch.models.llama import save_init_checkpoint

    root = ROOT / "build" / "exchange_layout"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ck = {k: str(root / k) for k in ("z1i8", "z1i8_2ep", "el", "el_cpu")}
    tp = XL_SMALL["tp2x2"]
    sgd = xl_small(**tp, optimizer="sgd", lr=0.5)
    save_init_checkpoint(sgd, ck["el"])
    z1i8 = xl_small(**tp, **XL_ZERO1, **XL_INT8)
    quad = []
    for lay, layout in XL_SMALL.items():
        quad += [(f"{lay}_ici32", xl_small(**layout)),
                 (f"{lay}_zero1", xl_small(**layout, **XL_ZERO1))]
    quad += [("tp2x2_el", sgd, {"checkpoint_dir": ck["el"]}),
             ("tp2x2_int8", xl_small(**tp, **XL_INT8)),
             ("tp2x2_z1i8", z1i8, {"checkpoint_dir": ck["z1i8"]}),
             ("tp2x2_z1i8_resume", z1i8,
              {"checkpoint_dir": ck["z1i8"], "n_epochs": 2}),
             ("tp2x2_z1i8_2ep", z1i8,
              {"checkpoint_dir": ck["z1i8_2ep"], "n_epochs": 2}),
             ("wide_ici32", xl_wide()), ("wide_zero1", xl_wide(**XL_ZERO1))]
    elastic = dict(sgd, elastic=True)
    go = root / "quad_done"
    pair = [("elastic", elastic, {"checkpoint_dir": ck["el"],
                                  "n_epochs": 2, "wait_for": str(go)}),
            ("elastic_cpu", elastic, {"checkpoint_dir": ck["el_cpu"],
                                      "n_epochs": 2, "device": "cpu"}),
            ("refuse_tp1", dict(z1i8, tp=1, elastic=True),
             {"checkpoint_dir": ck["z1i8"], "n_epochs": 3,
              "expect": XL_SPANNING})]
    # the two ranks start under the four (their start-up overlaps the
    # four's runs) and wait for the checkpoints those write
    pair_procs = pt_start(2, pair)
    try:
        t0 = time.perf_counter()
        quads = pt_spawn(4, quad)
        t_quad = time.perf_counter() - t0
        # the CPU resumes the card's checkpoint: the two runs of the
        # elastic epoch start from the same state
        shutil.copytree(ck["el"], ck["el_cpu"])
        go.touch()
    except BaseException:
        for p in pair_procs:
            p.kill()
            p.wait()
        raise
    t0 = time.perf_counter()
    pairs = pt_wait(pair_procs)
    t_pair = time.perf_counter() - t0

    shutil.rmtree(root, ignore_errors=True)

    def jobs(ranks, name):
        return [rk["jobs"][name] for rk in ranks]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    fails, res = [], {"quad_s": t_quad, "pair_s": t_pair}
    small = {}
    for lay in XL_SMALL:
        a, b = jobs(quads, f"{lay}_ici32"), jobs(quads, f"{lay}_zero1")
        bitwise = all(x["losses"] == y["losses"] for x, y in zip(a, b))
        worst = max(rel(y["losses"], x["losses"]) for x, y in zip(a, b))
        small[lay] = {"ici32": a[0]["losses"], "zero1": b[0]["losses"],
                      "bitwise": bitwise, "max_rel": worst}
        if worst > XL_RTOL or len(a[0]["losses"]) != 4:
            fails.append(f"{lay}: zero1 against ici32 {small[lay]}")
    i8 = max(rel(x["losses"], y["losses"]) for x, y in zip(
        jobs(quads, "tp2x2_int8"), jobs(quads, "tp2x2_ici32")))
    small["tp2x2_int8_max_rel"] = i8
    if i8 > EXCH_INT8_RTOL:
        fails.append(f"tp2x2 int8: {i8} from ici32 (> {EXCH_INT8_RTOL})")
    resumed = jobs(quads, "tp2x2_z1i8_resume")
    whole = jobs(quads, "tp2x2_z1i8_2ep")
    small["shards_resume_bitwise"] = all(
        x["losses"] == y["losses"] and len(y["losses"]) == 8
        for x, y in zip(resumed, whole))
    if not small["shards_resume_bitwise"]:
        fails.append(f".shards resume {resumed[0]['losses']} against "
                     f"{whole[0]['losses']}")
    card, cpu = jobs(pairs, "elastic"), jobs(pairs, "elastic_cpu")
    small["elastic"] = {"card": card[0]["losses"], "cpu": cpu[0]["losses"],
                        "batch_size": card[0]["batch_size"], "max_rel": max(
                            rel(x["losses"], y["losses"])
                            for x, y in zip(card, cpu))}
    # the "global" policy keeps the saved global batch 4 in the one data
    # replica's rows (the process count, 2, would halve it)
    if small["elastic"]["max_rel"] > TRAIN_REF_RTOL \
            or len(card[0]["losses"]) != 8 \
            or {j["batch_size"] for j in card + cpu} != {4}:
        fails.append(f"elastic resume: {small['elastic']}")
    refusals = [j.get("error", "") for j in jobs(pairs, "refuse_tp1")]
    small["refusal"] = refusals[0]
    if not all(XL_SPANNING in e for e in refusals):
        fails.append(f"tp = 1 resume of a tp = 2 zero1 state: {refusals}")
    res["small"] = small

    per_step = pt_launches_per_step(XL_WIDE, 0)
    want = {k: v * XL_STEPS for k, v in per_step.items()}
    wide = {}
    for arm in ("ici32", "zero1"):
        ranks = []
        for r, job in enumerate(jobs(quads, f"wide_{arm}")):
            if job["launches"] != want or job["tc_launches"] != want \
                    or job["plain_calls"]:
                fails.append(f"wide {arm} rank {r}: launches "
                             f"{job['launches']}, tensor cores "
                             f"{job['tc_launches']} (want {want}), plain "
                             f"{job['plain_calls']}")
            ranks.append({
                "coords": job["coords"], "losses": job["losses"],
                "step_s": job["step_s"],
                "median_step_ms": statistics.median(job["step_s"]) * 1e3,
                "peak_gib": job["peak_gib"],
                "params_b_rank": job["params_b_rank"],
                "launches": job["launches"],
                "collectives_ms_per_step": {
                    k: sum(v) / XL_STEPS
                    for k, v in job["collective_ms"].items()}})
        wide[arm] = ranks
    bitwise = all(a["losses"] == b["losses"]
                  for a, b in zip(wide["ici32"], wide["zero1"]))
    wide["bitwise"] = bitwise
    wide["peak_gib_saved"] = [a["peak_gib"] - b["peak_gib"] for a, b in
                              zip(wide["ici32"], wide["zero1"])]
    if not bitwise:
        fails.append("wide: zero1 losses differ from ici32's")
    res["wide"] = wide
    log(f"[exchange layout] {json.dumps(res)} on {card_line()}")
    # the small fp32 arms on the card: K1, K2 and K3 in three TF32
    # passes
    fp32_jobs = [j for name, _, *o in quad
                 if not name.startswith("wide") and not (
                     o and o[0].get("device") == "cpu")
                 for j in jobs(quads, name)] + jobs(pairs, "elastic")
    for j in fp32_jobs:
        if j["routes"] != routes_want("float32", j["launches"]):
            fails.append(f"fp32 arm launches, bf16 tensor-core, three-pass "
                         f"TF32: {j['routes']}")
    for k in ("K1", "K2", "K3"):
        n = sum(j["launches"][k] for arm in ("ici32", "zero1")
                for j in jobs(quads, f"wide_{arm}"))
        n32 = sum(j["launches"][k] for j in fp32_jobs)
        if k in records:
            add_launches(records[k], exchange_layout=n)
        if f"{k} fp32" in records:
            add_launches(records[f"{k} fp32"], exchange_layout=n32)
    if fails:
        raise AssertionError("exchange layout: " + "; ".join(fails))
    return res


def check_int8_legs(res: dict, n_buckets: int) -> None:
    """The int8 arm's step profile: the codec's ``quantize`` leg above 0
    and one ``exchange_b{i}`` leg a bucket of the flat spec."""
    legs = res["step_profile"]["legs_ms"]
    buckets = sorted(k for k in legs if k.startswith("exchange_b"))
    log(f"[exchange int8] quantize {legs.get('quantize')} ms, "
        f"{len(buckets)} exchange legs for {n_buckets} buckets, "
        f"exchange {sum(legs[k] for k in buckets):.2f} ms, optimizer "
        f"{legs.get('optimizer')} ms")
    if not legs.get("quantize", 0) > 0:
        raise AssertionError(f"exchange int8: no quantize leg in {legs}")
    if buckets != sorted(f"exchange_b{i}" for i in range(n_buckets)):
        raise AssertionError(f"exchange int8: legs {buckets} for "
                             f"{n_buckets} buckets")


def run_exchange_phase(dev, n_layers: int, records: dict) -> None:
    """The exchange phase (module docstring): zero1 and the int8 wire
    at one rank and Llama-3-8B widths through ``BSP().init``, the
    two-rank ``.shards`` arm, the TCP codec."""
    import torch

    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group

    use_synthetic_data()
    counters = {"K1": flash_fwd_cuda, "K2": flash_bwd_dkv_cuda,
                "K3": flash_bwd_dq_cuda}
    arms = {}
    for arm, extra in (("zero1", dict(exch_strategy="zero1")),
                       ("int8", dict(exch_strategy="zero1",
                                     exch_compression="int8"))):
        t0 = time.perf_counter()
        init_group(dev)
        try:
            res, model = run_training(dev, n_layers, counters,
                                      name=f"exchange {arm}",
                                      profile=arm == "int8", **extra)
            res["profile"] = profile_training(model, name=f"exchange {arm}")
            if arm == "int8":
                check_int8_legs(res, model._fspec.n_buckets)
        finally:
            destroy_group()
        res["arm_s"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        arms[arm] = res
        for k in counters:
            add_launches(records.setdefault(k, {}),
                         **{f"exchange_{arm}": res["launches"][k]})
    ref = TRAINED.get("ici32")
    z1, i8 = arms["zero1"]["losses"], arms["int8"]["losses"]
    if ref is not None and ref["config"]["n_layers"] == n_layers:
        base = ref["losses"]
        equal = z1 == base
        rel = max(abs(a - b) / abs(b) for a, b in zip(i8, base))
        log(f"[exchange] losses: ici32 {base}, zero1 {z1} "
            f"({'bitwise equal' if equal else 'DIFFER'}), int8 {i8} (max "
            f"relative difference {rel:.3e}, rtol {EXCH_INT8_RTOL})")
        if not equal:
            raise AssertionError("exchange: zero1 losses differ from ici32's")
        if rel > EXCH_INT8_RTOL:
            raise AssertionError("exchange: int8 losses left ici32's")
    else:
        check_train_trajectory("exchange zero1", arms["zero1"])
        base = TRAIN_TRAJECTORY
        rel = max(abs(i8[0] - base["first"]) / base["first"],
                  abs(i8[-1] - base["last"]) / base["last"])
        log(f"[exchange] no ici32 run at this depth in this run: zero1 held "
            f"to TRAIN_TRAJECTORY, int8 {i8} within {rel:.3e} of it (rtol "
            f"{EXCH_INT8_RTOL})")
        if rel > EXCH_INT8_RTOL:
            raise AssertionError("exchange: int8 losses left the trajectory")
    side = {"ici32": ref} if ref is not None else {}
    side.update(arms)
    log("[exchange] by exchange: " + json.dumps({
        k: {"median_step_s": v["median_step_s"], "arm_s": v.get("arm_s"),
            "tokens_per_s": v["tokens_per_s"], "peak_gib": v["peak_gib"],
            "device_ms_by_kind": {
                kind: ms for kind, ms in v.get("profile", {}).get(
                    "device_ms_per_step_by_kind", {}).items()
                if kind in ("elementwise", "memcpy/memset", "GEMM (cuBLAS)",
                            "reductions")},
            "busy_share": v.get("profile", {}).get("busy_share")}
        for k, v in side.items()}) + f" on {card_line()}")
    t0 = time.perf_counter()
    shards = exchange_shards_arm(dev, records)
    shards["arm_s"] = time.perf_counter() - t0
    log(f"[exchange shards] {json.dumps(shards)} on {card_line()}")
    log("[exchange shards] gloo on card 0 took reduce_scatter_tensor, "
        "all_gather_into_tensor and all_to_all_single on CUDA tensors "
        "(the port stages none of them; gloo copies through the host "
        "itself)")
    t0 = time.perf_counter()
    exchange_tcp_arm(dev)
    log(f"[exchange tcp] arm {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    exchange_layout_arm(dev, records)
    log(f"[exchange layout] arm {time.perf_counter() - t0:.1f} s")


# the resilience phase: the supervisor, the drills, checkpoint validation
# and the elastic resume, on the port's BSP worker
RES_EPOCHS = 5           # the drill matrix: 3 steps an epoch, small fp32
# each drill fires after a committed checkpoint: die in epoch 1 (back to
# ckpt_0), hang in 2 (back to ckpt_1), sigterm in 3 (the preemption
# checkpoint, resumed inside epoch 3), corrupt_ckpt in 4 (ckpt_3
# quarantined, back to ckpt_2)
RES_DRILLS = "1:1:die,2:1:hang,3:0:sigterm,4:1:corrupt_ckpt"
RES_CAUSES = [("preemption", 137, [0, None]), ("hang", None, [1, None]),
              ("sigterm", 0, [3, 1]), ("preemption", 137, [2, None])]
RES_STALL_S = 8.0        # a small model's step and epoch save take < 1 s
RES_GRACE_S = 120.0      # a life's first beat: start, CUDA, build, step
RES_LAYERS = 1           # the full-width arm's depth (REDUCED)
RES_STEPS = 6            # its epoch: sigterm after step 2, resumed at 3
RES_SIGTERM = "0:2:sigterm"
RES_WIDE_STALL_S = 600.0  # covers the 17.8 GB epoch-end save
RES_CHILD_TIMEOUT_S = 600
RES_SUPERVISE = dict(backoff_base_s=0.1, backoff_cap_s=1.0, seed=0,
                     poll_interval_s=0.05)
# the elastic relaunch against a one-rank resume of the same checkpoint:
# the same one-rank computation on the same card (gloo in the child,
# NCCL here: a one-rank reduce-scatter and all-gather are copies)
RES_ELASTIC_RTOL = 1e-6


def process_age_s() -> float | None:
    """Seconds since this process started (Linux ``/proc``), else None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def install_journal(directory: str) -> None:
    """Keep this process's journal, ``<directory>/worker.<pid>.json``,
    current after every step, restore and save: the steps it ran, the
    K1/K2/K3 wrappers' launch counts (all, and those on the tensor
    cores), the resume's seconds (``validate_s``: the checkpoint chosen
    and hashed; ``load_s``: its restore; ``resume_s`` both), each save's
    seconds, and the process's age when its model was built and when its
    first step ended.  A supervised run's lives are processes of their
    own, some ended by ``os._exit`` (a drill): the journal is how this
    script reads their launches and checkpoint times.  It wraps the
    port's functions in this process only."""
    from theanompi_tpu_torch.models import base
    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.ops import attention as att
    from theanompi_tpu_torch.workers import bsp_worker

    path = Path(directory) / f"worker.{os.getpid()}.json"
    rec = {"steps": 0, "validate_s": None, "load_s": None, "resume_s": None,
           "save_s": [], "age_s": {}}

    def write() -> None:
        rec["launches"] = {k: route_counts(fn) for k, fn in (
            ("K1", att.flash_fwd_cuda), ("K2", att.flash_bwd_dkv_cuda),
            ("K3", att.flash_bwd_dq_cuda))}
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, path)

    def wrap(owner, name: str, after) -> None:
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            after(time.perf_counter() - t0)
            write()
            return out

        setattr(owner, name, timed)

    def step(_dt: float) -> None:
        rec["steps"] += 1
        if rec["steps"] == 1:
            rec["age_s"]["first_step"] = process_age_s()

    def loaded(dt: float) -> None:
        rec["load_s"] = dt
        rec["resume_s"] = (rec["validate_s"] or 0.0) + dt

    wrap(bsp_worker, "resume_checkpoint",
         lambda dt: rec.__setitem__("validate_s", dt))
    wrap(base.TMModel, "load", loaded)
    wrap(base.TMModel, "save", rec["save_s"].append)
    wrap(Llama, "build_model",
         lambda _dt: rec["age_s"].__setitem__("built", process_age_s()))
    wrap(Llama, "train_iter", step)


def journal_worker() -> None:
    """One process of a supervised arm's run (``journaled_bsp``): the
    port's ``bsp_worker.worker_main`` (its argv: ``--spec-json``,
    ``--rank``, ...) under ``install_journal``."""
    from theanompi_tpu_torch.workers import bsp_worker

    install_journal(os.environ["CHIP_SMOKE_JOURNAL"])
    bsp_worker.worker_main()


def journaled_bsp():
    """``BSP()`` whose processes start as this script (``journal_worker``)
    in place of ``python -m theanompi_tpu_torch.workers.bsp_worker``: the
    same ``worker_main`` and ``run``, with the journal kept."""
    from theanompi_tpu_torch import BSP

    rule = BSP()
    rule.worker_module = "chip_smoke"
    return rule


def journals(d: Path) -> list[dict]:
    """The journals (``install_journal``) a supervised run's processes
    left in ``d``, oldest process first."""
    return [json.loads(f.read_text())
            for f in sorted(d.glob("worker.*.json"),
                            key=lambda f: f.stat().st_mtime)]


def journal_launches(js: list[dict]) -> dict:
    """K1/K2/K3 launches summed over every process: ``{k: [all, on the
    bf16 tensor-core kernel, in three TF32 passes]}``."""
    out = {k: [0, 0, 0] for k in ("K1", "K2", "K3")}
    for j in js:
        for k, counts in j["launches"].items():
            out[k] = [a + b for a, b in zip(out[k], counts)]
    return out


def fp32_routes_ok(launches: dict) -> bool:
    """``journal_launches`` of an fp32 run: each kernel launched, each on
    its fp32 route."""
    return all(v[0] for v in launches.values()) and launches == \
        routes_want("float32", {k: v[0] for k, v in launches.items()})


def supervised_env(**env) -> None:
    """Set (or, for None, drop) environment variables for the next
    launch, which copies this process's environment."""
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


def restarts_line(rep: dict) -> list:
    return [{k: e[k] for k in ("cause", "exit_code", "resumed_from",
                               "recovery_s", "backoff_s", "world_size",
                               "resharded")} for e in rep["restarts"]]


def check_restarts(name: str, rep: dict, want: list) -> None:
    got = [(e["cause"], e["exit_code"], e["resumed_from"])
           for e in rep["restarts"]]
    log(f"[{name}] restarts {json.dumps(restarts_line(rep))}, MTTR "
        f"{rep['mttr_s']} s")
    if not rep["completed"] or got != want:
        raise AssertionError(f"{name}: restarts {got}, want {want}")


def final_losses(d: Path) -> list:
    from theanompi_tpu_torch.utils import checkpoint as ckpt

    meta = ckpt.checkpoint_meta(ckpt.latest_checkpoint(d))
    return meta["recorder"]["train_losses"]


def resilience_drills(dev, root: Path, records: dict) -> dict:
    """Arm 1: the drill matrix on the small fp32 model (the fp32 K1-K3), one
    rank on card 0, one ``BSP().init(launch="supervised")``; against an
    unsupervised run from the same init checkpoint."""
    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.models.llama import save_init_checkpoint

    init, d, ref, jd = (root / n for n in ("init", "drills", "ref",
                                           "journal"))
    save_init_checkpoint(TRAIN_SMALL, init)
    shutil.copytree(init, d)
    jd.mkdir()
    supervised_env(TM_FAULT_AT=RES_DRILLS, CHIP_SMOKE_JOURNAL=jd)
    t0 = time.perf_counter()
    try:
        rule = journaled_bsp()
        rule.init(devices=[dev.index], launch="supervised",
                  config=TRAIN_SMALL, n_epochs=RES_EPOCHS,
                  checkpoint_dir=str(d), resume=True, verbose=False,
                  supervise=dict(RES_SUPERVISE, stall_timeout_s=RES_STALL_S,
                                 startup_grace_s=RES_GRACE_S), **LLAMA)
        rep = rule.wait()
    finally:
        supervised_env(TM_FAULT_AT=None, CHIP_SMOKE_JOURNAL=None)
    wall = time.perf_counter() - t0
    check_restarts("resilience drills", rep, RES_CAUSES)
    quarantined = sorted(p.name for p in d.glob("*.corrupt"))
    if "ckpt_3.npz.corrupt" not in quarantined:
        raise AssertionError(f"resilience drills: quarantined {quarantined}")
    got = final_losses(d)
    shutil.copytree(init, ref)
    rule = BSP()
    rule.init(devices=[dev.index], launch="inprocess", config=TRAIN_SMALL,
              n_epochs=RES_EPOCHS, checkpoint_dir=str(ref), resume=True,
              verbose=False, **LLAMA)
    want = rule.wait()["recorder"].train_losses
    js = journals(jd)
    launches = journal_launches(js)
    res = {"wall_s": wall, "lives": len(js), "mttr_s": rep["mttr_s"],
           "recovery_s": [e["recovery_s"] for e in rep["restarts"]],
           "age_s_by_life": [j["age_s"] for j in js],
           "quarantined": quarantined, "losses": got,
           "equal_to_unsupervised": got == want, "launches": launches}
    log(f"[resilience drills] {json.dumps(res)} on {card_line()}")
    if len(got) != RES_EPOCHS * 3 or got != want:
        raise AssertionError(f"resilience drills: losses {got}, the "
                             f"unsupervised run's {want}")
    if not fp32_routes_ok(launches):
        raise AssertionError(f"resilience drills: launches {launches} (fp32 "
                             f"kernels, each launched, on their routes)")
    for k in ("K1", "K2", "K3"):
        add_launches(records.setdefault(f"{k} fp32", {}),
                     resilience_drills=launches[k][0])
    return res


def wide_config() -> dict:
    from theanompi_tpu_torch.models import LLAMA3_8B

    return dict(LLAMA3_8B, n_layers=RES_LAYERS, seq_len=2048, batch_size=2,
                n_train=RES_STEPS * 2, n_val=2, compute_dtype="bfloat16",
                optimizer="adam", lr=1e-4, remat=True, xent_chunks="auto",
                exch_strategy="ici32", seed=0)


def resilience_preemption(dev, root: Path, records: dict,
                          meanwhile=None) -> dict:
    """Arm 2: graceful preemption at Llama-3-8B widths (bf16, K1-K3 on
    the tensor cores), ``RES_LAYERS`` deep: one supervised launch, a
    sigterm drill after step 2, the preemption checkpoint, the relaunch
    resumed inside the epoch; against an uninterrupted run.  The
    supervised run spends most of its time writing, hashing and reading
    its checkpoint with the card idle, so ``meanwhile()`` (the other
    arms) runs in this thread while a second one waits on the
    supervisor; the launch took its environment before they start."""
    import torch

    from theanompi_tpu_torch import BSP

    cfg = wide_config()
    d, jd = root / "wide", root / "wide_journal"
    jd.mkdir()
    torch.cuda.empty_cache()
    supervised_env(TM_FAULT_AT=RES_SIGTERM, CHIP_SMOKE_JOURNAL=jd)
    t0 = time.perf_counter()
    try:
        rule = journaled_bsp()
        rule.init(devices=[dev.index], launch="supervised", config=cfg,
                  n_epochs=1, checkpoint_dir=str(d), verbose=False,
                  supervise=dict(RES_SUPERVISE,
                                 stall_timeout_s=RES_WIDE_STALL_S,
                                 startup_grace_s=RES_WIDE_STALL_S), **LLAMA)
    finally:
        supervised_env(TM_FAULT_AT=None, CHIP_SMOKE_JOURNAL=None)
    box = {}

    def supervise() -> None:
        try:
            box["rep"] = rule.wait()
        except BaseException as e:      # re-raised in this thread
            box["error"] = e
        box["wall"] = time.perf_counter() - t0

    waiter = threading.Thread(target=supervise, daemon=True)
    waiter.start()
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        waiter.join()
    if "error" in box:
        raise box["error"]
    rep, wall = box["rep"], box["wall"]
    nxt = int(RES_SIGTERM.split(":")[1]) + 1
    check_restarts("resilience preemption", rep, [("sigterm", 0, [0, nxt])])
    got = final_losses(d)
    ckpt_gib = sum(f.stat().st_size for f in d.glob("ckpt_*.npz")) / 2**30
    first, second = journals(jd)
    launches = journal_launches([first, second])
    shutil.rmtree(d)
    out = BSP()
    out.init(devices=[dev.index], launch="inprocess", config=cfg, n_epochs=1,
             verbose=False, **LLAMA)
    want = out.wait()["recorder"].train_losses
    torch.cuda.empty_cache()
    res = {"config": {k: cfg[k] for k in ("dim", "n_layers", "n_heads",
                                          "n_kv_heads", "ffn_dim", "vocab",
                                          "seq_len", "batch_size")},
           "wall_s": wall, "ckpt_gib": ckpt_gib,
           "preemption_save_s": first["save_s"],
           "resume_s": second["resume_s"],
           "resume_validate_s": second["validate_s"],
           "resume_load_s": second["load_s"], "epoch_save_s": second["save_s"],
           "recovery_s": rep["restarts"][0]["recovery_s"],
           "age_s_by_life": [first["age_s"], second["age_s"]],
           "steps_before_after": [first["steps"], second["steps"]],
           "losses": got, "uninterrupted": want,
           "equal_to_uninterrupted": got == want, "launches": launches}
    log(f"[resilience preemption] {json.dumps(res)} on {card_line()}")
    if res["steps_before_after"] != [nxt, RES_STEPS - nxt]:
        raise AssertionError(f"resilience preemption: steps a life "
                             f"{res['steps_before_after']}: a step lost or "
                             f"repeated")
    if len(got) != RES_STEPS or got != want:
        raise AssertionError(f"resilience preemption: losses {got}, the "
                             f"uninterrupted run's {want}")
    wl = {"K1": 2 * RES_LAYERS * RES_STEPS + RES_LAYERS,
          "K2": RES_LAYERS * RES_STEPS, "K3": RES_LAYERS * RES_STEPS}
    if launches != routes_want("bfloat16", wl):
        raise AssertionError(f"resilience preemption: launches {launches}, "
                             f"want {wl} all on the tensor cores")
    for k in ("K1", "K2", "K3"):
        add_launches(records.setdefault(k, {}),
                     resilience_preemption=launches[k][0])
    return res


def elastic_config() -> dict:
    """The elastic arm's small fp32 model: batch 2 a rank at two ranks
    (global 4), zero1 over a bucketed layout, so the one-rank relaunch
    regrids the flat optimizer shards (a real reshard)."""
    return dict(TRAIN_SMALL, n_train=12, n_val=4, exch_strategy="zero1",
                exchange_bucket_mb=0.25, elastic=True)


def resilience_rank(dev, rank: int, world: int, init: str,
                    spec: dict) -> None:
    """One rank of the elastic arm (``--resilience-rank r``): a gloo group
    on card 0 (NCCL refuses two ranks on one card), the one-element max
    allreduce of the preemption agreement and its host read timed at
    this world (the cost a supervised step pays at more than one rank),
    then the port's BSP worker in that group."""
    import torch
    import torch.distributed as dist

    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
    from theanompi_tpu_torch.workers import bsp_worker

    install_journal(os.environ["CHIP_SMOKE_JOURNAL"])
    init_group(dev, rank, world, init, backend="gloo")
    try:
        flag = torch.zeros(1, device=dev)
        for _ in range(5):
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            flag.item()
        t0 = time.perf_counter()
        for _ in range(50):
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            flag.item()
        flag_ms = (time.perf_counter() - t0) / 50 * 1e3
        if rank == 0:     # written now: a drill may end this life
            Path(spec["out"]).with_suffix(".flag").write_text(
                json.dumps({"world": world, "flag_allreduce_ms": flag_ms}))
        out = bsp_worker.run(devices=[dev.index] * world, rank=rank,
                             world_size=world, init_method=init,
                             config=spec["config"], n_epochs=spec["n_epochs"],
                             checkpoint_dir=spec["checkpoint_dir"],
                             resume=spec["resume"], verbose=False, **LLAMA)
        if rank == 0:
            Path(spec["out"]).write_text(json.dumps({
                "world": world, "losses": out["recorder"].train_losses,
                "elastic_resume": out["elastic_resume"],
                "resharded": out["resharded"],
                "resumed_from": out["resumed_from"]}))
    finally:
        destroy_group()


def resilience_elastic(dev, root: Path, records: dict) -> dict:
    """Arm 3: two ranks on card 0 over gloo under an elastic supervisor;
    ``shrink_world`` in epoch 1 takes the world to 1; the relaunch keeps
    the global batch and reshards the zero1 state; against a one-rank
    run resumed from a copy of the same checkpoint."""
    from theanompi_tpu_torch import BSP, launcher
    from theanompi_tpu_torch.utils.supervisor import Supervisor

    cfg = elastic_config()
    d, jd, out = root / "elastic", root / "elastic_journal", root / "el"
    jd.mkdir()
    out.mkdir()

    def cmd_for(resume: bool, n_devices: int | None = None) -> list:
        n = int(n_devices or 2)
        spec = json.dumps({"config": cfg, "n_epochs": 2, "resume": resume,
                           "checkpoint_dir": str(d),
                           "out": str(out / f"world{n}.json")})
        return launcher.rank_group_cmd([
            [sys.executable, str(ROOT / "chip_smoke.py"), "--resilience-rank",
             str(r), "--resilience-world", str(n), "--resilience-init",
             launcher.INIT_METHOD, "--resilience-spec", spec]
            for r in range(n)])

    supervised_env(TM_FAULT_AT="1:1:shrink_world", CHIP_SMOKE_JOURNAL=jd)
    t0 = time.perf_counter()
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        rep = Supervisor(cmd_for=cmd_for, checkpoint_dir=str(d), elastic=True,
                         n_devices=2, env=env, verbose=False,
                         stall_timeout_s=RES_STALL_S * 3,
                         startup_grace_s=RES_GRACE_S, **RES_SUPERVISE).run()
    finally:
        supervised_env(TM_FAULT_AT=None, CHIP_SMOKE_JOURNAL=None)
    wall = time.perf_counter() - t0
    check_restarts("resilience elastic", rep, [("preemption", 137, [0, None])])
    one = json.loads((out / "world1.json").read_text())
    ref = root / "elastic_ref"
    ref.mkdir()
    shutil.copytree(d / "ckpt_0.shards", ref / "ckpt_0.shards")
    rule = BSP()
    rule.init(devices=[dev.index], launch="inprocess", config=cfg,
              n_epochs=2, checkpoint_dir=str(ref), resume=True,
              verbose=False, **LLAMA)
    want = rule.wait()["recorder"].train_losses
    got = final_losses(d)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    launches = journal_launches(journals(jd))
    res = {"wall_s": wall, "world_size_history": rep["world_size_history"],
           "elastic_resume": one["elastic_resume"],
           "resharded": one["resharded"], "losses": got, "resumed_one_rank":
           want, "max_rel_diff": rel, "launches": launches,
           "recovery_s": rep["restarts"][0]["recovery_s"],
           "flag_allreduce_ms": {
               n: json.loads((out / f"world{n}.flag").read_text())[
                   "flag_allreduce_ms"] for n in (2, 1)}}
    log(f"[resilience elastic] {json.dumps(res)} on {card_line()}")
    if rep["world_size_history"] != [2, 1]:
        raise AssertionError(f"resilience elastic: world sizes "
                             f"{rep['world_size_history']}")
    note = {"policy": "global", "saved_world": 2, "saved_global": 4,
            "batch_size": 4}
    if one["elastic_resume"] != note or not one["resharded"] or \
            not rep["restarts"][0]["resharded"]:
        raise AssertionError(f"resilience elastic: note "
                             f"{one['elastic_resume']}, resharded "
                             f"{one['resharded']}")
    if len(got) != len(want) or rel > RES_ELASTIC_RTOL:
        raise AssertionError(f"resilience elastic: losses {got}, the "
                             f"one-rank resume's {want}")
    if not fp32_routes_ok(launches):
        raise AssertionError(f"resilience elastic: launches {launches} (fp32 "
                             f"kernels, each launched, on their routes)")
    for k in ("K1", "K2", "K3"):
        add_launches(records.setdefault(f"{k} fp32", {}),
                     resilience_elastic=launches[k][0])
    return res


def run_resilience_phase(dev, records: dict) -> None:
    """The resilience phase (module docstring): the drill matrix, graceful
    preemption at full width, the elastic shrink."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    root = ROOT / "build" / "resilience"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    arms = {}

    def beside() -> None:
        for name, arm in (("drills", resilience_drills),
                          ("elastic", resilience_elastic)):
            t0 = time.perf_counter()
            arms[name] = arm(dev, root, records)
            arms[name]["arm_s"] = time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        arms["preemption"] = resilience_preemption(dev, root, records,
                                                   meanwhile=beside)
        arms["preemption"]["arm_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("[resilience] " + json.dumps({
        "arm_s": {k: v["arm_s"] for k, v in arms.items()},
        "mttr_s": {k: v.get("mttr_s") for k, v in arms.items()},
        "flag_allreduce_ms_gloo_by_world":
            arms["elastic"]["flag_allreduce_ms"],
        "preemption_ckpt_gib": arms["preemption"]["ckpt_gib"],
        "preemption_save_s": arms["preemption"]["preemption_save_s"],
        "resume_s": arms["preemption"]["resume_s"]}) + f" on {card_line()}")


# -- phase 12: tensor- and sequence-parallel training ------------------------

PT_LAYERS = 2            # depth of the full-width layouts (REDUCED)
PT_SEQ = 8192            # LLAMA3_8B.seq_len: the ring's home
PT_STEPS = 2
# the layouts of the two-process arm, run in turn in the same processes
PT_PAIR = {"tp2": dict(tp=2), "ring": dict(sp=2, sp_mode="ring"),
           "ulysses": dict(sp=2, sp_mode="ulysses")}
# the four-process arm
PT_QUAD = {"tp2_ring": dict(tp=2, sp=2, sp_mode="ring")}
# per-step losses of a layout against the one-rank run from the same
# init and batches.  bf16: the layouts round other partial sums (two
# row-parallel partial products, the ring's per-hop merge of o rounded
# to bf16 by K1, the all-to-alls' other block shapes) and Adam carries
# that on (measured at most 3.1e-6 over 3 steps on an H100); fp32:
# summation order only (measured 7.5e-8)
PT_RTOL = {"bfloat16": 1e-4, "float32": 1e-5}
# the L2 norm of each leaf's gradient after the first step's exchange
# (a sharded leaf's over its model group) against the one-rank run's:
# the losses move little in 3 Adam steps from a random init and Adam
# hides a gradient's scale, so this is what holds the layouts' gradients
# at full width.  bf16: the layouts round other partial sums (see
# PT_RTOL); fp32: summation order only
PT_GRAD_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
#: the Llama's flash entry points' plain versions and SDPA: the path must
#: call none of them on the card
PT_PLAIN = ("mha_reference", "mha_reference_fwd", "flash_bwd_reference")


def pt_config(dtype: str, **layout) -> dict:
    """A parallel_train run: Llama-3-8B widths at ``PT_LAYERS`` and seq
    ``PT_SEQ`` in bf16 (Adam, remat, the chunked head), or the small
    model in fp32 (SGD at lr 0.5, which a wrongly scaled gradient would
    move); batch 1, ``PT_STEPS`` steps, no val pass."""
    from theanompi_tpu_torch.models import LLAMA3_8B

    if dtype == "bfloat16":
        cfg = dict(LLAMA3_8B, n_layers=PT_LAYERS, seq_len=PT_SEQ,
                   compute_dtype="bfloat16", optimizer="adam", lr=1e-4,
                   remat=True, xent_chunks="auto", seed=0)
    else:
        cfg = dict(SMALL, optimizer="sgd", lr=0.5, remat=True)
    cfg.update(batch_size=1, n_train=PT_STEPS, n_val=0,
               exch_strategy="ici32", **layout)
    return cfg


def grad_norm_probe(cls, box: dict):
    """Wrap ``cls._exchange_update`` so that the first step's exchanged
    gradients (the exchange reduces them in place; the optimizer reads
    them) leave each leaf's sum of squares in ``box``, by leaf name
    (an fp32 norm: no copy of the leaf, so the peak memory is the
    path's own); returns the original for restoring."""
    import torch

    from theanompi_tpu_torch.models.llama import leaf_names

    orig = cls._exchange_update

    def probe(self, leaves, grads):
        orig(self, leaves, grads)
        if not box:
            # a stage's layers by their global index
            names = leaf_names(self.params, self.layer_offset)
            box.update((n, float(torch.linalg.vector_norm(g)) ** 2)
                       for n, g in zip(names, grads))

    cls._exchange_update = probe
    return orig


def expert_load_probe(cls, box: dict):
    """Wrap ``cls._aux_from_moments`` so that the first call (the first
    step's forward) leaves each layer's expert load ``f`` (the fraction
    of the picks each expert took, over every token-sharding rank) in
    ``box["f"]``; returns the original for restoring."""
    orig = cls._aux_from_moments

    def probe(self, moms):
        if "f" not in box:
            box["f"] = moms[:, :self.n_experts].detach().float().tolist()
        return orig(self, moms)

    cls._aux_from_moments = probe
    return orig


def pt_grad_norms(ranks: list, name: str) -> dict:
    """Each leaf's full gradient norm from the ranks of one layout, at
    data and seq coordinate 0: a leaf split over the model group summed
    over its model ranks (else model rank 0's), an expert leaf over its
    expert ranks (else expert rank 0's), a stage's layers from their
    stage, the leaves every stage holds from stage 0."""
    from theanompi_tpu_torch.models.llama import EXPERT_LEAVES, MODEL_AXIS

    sums: dict = {}
    for rk in ranks:
        job = rk["jobs"][name]
        p, e, d, m, s = job["coords"]
        if d or s:
            continue
        for leaf, sq in job["grad_sq"].items():
            k = leaf.rsplit(".", 1)[-1]
            if (m and MODEL_AXIS[k] is None) \
                    or (e and k not in EXPERT_LEAVES) \
                    or (p and not leaf.startswith("layers.")):
                continue             # a copy of another rank's
            sums[leaf] = sums.get(leaf, 0.0) + sq
    return {k: math.sqrt(v) for k, v in sums.items()}


def pt_launches_per_step(layout: dict, seq_rank: int) -> dict:
    """K1/K2/K3 launches a rank makes a step: the forward runs twice
    under remat; at sp = s causal the ring folds seq rank r's r + 1
    visible hops a layer (Ulysses and tp run one launch a layer)."""
    hops = (seq_rank + 1 if layout.get("sp", 1) > 1
            and layout.get("sp_mode", "ring") == "ring" else 1)
    n = pt_config("bfloat16")["n_layers"] * hops
    return {"K1": 2 * n, "K2": n, "K3": n}


class _TimedDist:
    """``torch.distributed`` as one of the port's modules sees it, with
    the wall time of each of its all-to-alls and all-reduces (the device
    synchronized around it) kept under the module's ``kind`` (its
    all-reduces' under ``all_reduce`` when given): the ring's hop, the
    Ulysses all-to-all, the tp all-reduces, the gradient exchange's
    all-reduces (at sp = 2 and one data replica, the seq group's f32
    gradient mean), the MoE token all-to-alls and aux means, the
    pipeline's chain hops and broadcasts, the pipe sum."""

    def __init__(self, real, kind: str, times: dict,
                 all_reduce: str | None = None):
        self._real, self._kind, self._times = real, kind, times
        self._ar_kind = all_reduce or kind

    def __getattr__(self, name):
        return getattr(self._real, name)

    def _timed(self, kind, fn, *a, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self._times.setdefault(kind, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def all_to_all_single(self, *a, **kw):
        return self._timed(self._kind, self._real.all_to_all_single, *a,
                           **kw)

    def all_reduce(self, *a, **kw):
        return self._timed(self._ar_kind, self._real.all_reduce, *a, **kw)

    def reduce_scatter_tensor(self, *a, **kw):
        return self._timed(f"{self._kind}_reduce_scatter",
                           self._real.reduce_scatter_tensor, *a, **kw)

    def all_gather_into_tensor(self, *a, **kw):
        return self._timed(f"{self._kind}_all_gather",
                           self._real.all_gather_into_tensor, *a, **kw)


def pt_rank(dev, rank: int, world: int, init: str, jobs: list) -> None:
    """One rank of a parallel_train arm (``--pt-rank``): a gloo group on
    card 0, then each job (name, config[, options]) through
    ``bsp_worker.run`` in turn, with each step timed, K1/K2/K3 counted,
    the plain versions and SDPA counted (none may run), the layout's
    collectives timed and the peak memory; its numbers as the last line
    of standard output.  The options (the exchange phase's layout arms):
    ``checkpoint_dir`` (saved each epoch, resumed from), ``n_epochs``,
    ``device`` ("cpu": the job's reference run on the host, in the same
    group), ``expect`` (the job must raise a ``ValueError`` holding
    these words; its message is the job's result) and ``wait_for`` (a
    path the job waits to exist first: ranks started ahead of the runs
    whose checkpoints they resume)."""
    import torch
    import torch.distributed as tdist
    import torch.nn.functional as F

    from theanompi_tpu_torch.models import base as base_mod
    from theanompi_tpu_torch.models import llama as llama_mod
    from theanompi_tpu_torch.ops import attention as attn
    from theanompi_tpu_torch.parallel import collectives, exchange, ulysses
    from theanompi_tpu_torch.parallel import moe, pp
    from theanompi_tpu_torch.parallel import tp as tp_lib
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
    from theanompi_tpu_torch.workers import bsp_worker

    init_group(dev, rank, world, init, backend="gloo")
    counters = {"K1": attn.flash_fwd_cuda, "K2": attn.flash_bwd_dkv_cuda,
                "K3": attn.flash_bwd_dq_cuda}
    plain_calls = {}

    def counting(name, fn):
        def wrapped(*a, **kw):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for name in PT_PLAIN:
        setattr(attn, name, counting(name, getattr(attn, name)))
    F.scaled_dot_product_attention = counting(
        "sdpa", F.scaled_dot_product_attention)
    times = {}
    ulysses.dist = _TimedDist(tdist, "ulysses_a2a", times)
    exchange.dist = _TimedDist(tdist, "grad_exchange", times)
    tp_lib.dist = _TimedDist(tdist, "tp_all_reduce", times)
    moe.dist = _TimedDist(tdist, "moe_a2a", times, all_reduce="moe_aux_mean")
    pp.dist = _TimedDist(tdist, "pipe_value", times)
    base_mod.dist = _TimedDist(tdist, "pipe_sum", times)
    steps = []
    train_iter = llama_mod.Llama.train_iter

    def timed(self, count, recorder):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_iter(self, count, recorder)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)

    llama_mod.Llama.train_iter = timed
    grad_sq = {}
    exchange_update = grad_norm_probe(llama_mod.Llama, grad_sq)
    load = {}
    aux_from = expert_load_probe(llama_mod.Llama, load)
    out = {}
    try:
        for name, cfg, *opts in jobs:
            opts = opts[0] if opts else {}
            t_wait = time.perf_counter()
            while "wait_for" in opts and not Path(opts["wait_for"]).exists():
                if time.perf_counter() - t_wait > DIST_CHILD_TIMEOUT_S:
                    raise TimeoutError(f"{name}: {opts['wait_for']}")
                time.sleep(0.1)
            run_dev = torch.device(opts.get("device", dev))
            reset_counts(*counters.values())
            plain_calls.clear()
            times.clear()
            steps.clear()
            grad_sq.clear()
            load.clear()
            torch.cuda.reset_peak_memory_stats()
            # the ring's hop and the pipeline's chain hop are the one
            # permutation collective; no arm runs both
            collectives.dist = _TimedDist(
                tdist, "chain_hop" if int(cfg.get("pp", 1)) > 1
                else "ring_hop", times)
            try:
                res = bsp_worker.run(
                    devices=[run_dev] * world, rank=rank, world_size=world,
                    init_method=init, config=cfg,
                    n_epochs=opts.get("n_epochs", 1),
                    checkpoint_dir=opts.get("checkpoint_dir"),
                    resume="checkpoint_dir" in opts, verbose=False,
                    **LLAMA)
            except ValueError as e:
                if not opts.get("expect") or opts["expect"] not in str(e):
                    raise
                out[name] = {"error": str(e)}
                continue
            model = res["model"]
            out[name] = {
                "losses": res["recorder"].train_losses,
                "step_s": list(steps),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": {k: fn.launches for k, fn in counters.items()},
                "tc_launches": {k: fn.tc_launches
                                for k, fn in counters.items()},
                "routes": {k: route_counts(fn)
                           for k, fn in counters.items()},
                "plain_calls": dict(plain_calls),
                "collective_ms": {k: list(v) for k, v in times.items()},
                "seq_rank": model.layout.seq.rank,
                "coords": list(model.layout.coords),
                "params_b_rank": sum(t.numel() for t in model._leaves())
                / 1e9,
                "batch_size": model.data.batch_size,
                "grad_sq": dict(grad_sq),
                "expert_load": load.get("f"),
            }
            del res, model
            torch.cuda.empty_cache()
    finally:
        llama_mod.Llama.train_iter = train_iter
        llama_mod.Llama._exchange_update = exchange_update
        llama_mod.Llama._aux_from_moments = aux_from
        destroy_group()
    print(json.dumps({"rank": rank, "jobs": out}), flush=True)


def pt_start(world: int, jobs: list) -> list:
    """Start ``world`` ranks on card 0 (``chip_smoke.py --pt-rank r``)
    over one gloo group; ``pt_wait`` collects them."""
    init = f"tcp://127.0.0.1:{free_port()}"
    spec = json.dumps(jobs)
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--pt-rank", str(r),
         "--pt-world", str(world), "--pt-init", init, "--pt-jobs", spec],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def pt_spawn(world: int, jobs: list) -> list[dict]:
    """Run ``world`` ranks on card 0 (``pt_start``); their numbers, rank
    order."""
    return pt_wait(pt_start(world, jobs))


def pt_wait(procs: list) -> list[dict]:
    """The numbers of ranks ``pt_start`` started, rank order (every rank
    killed if one does not end)."""
    world = len(procs)
    outs = []
    try:
        for p in procs:
            log_, _ = p.communicate(timeout=DIST_CHILD_TIMEOUT_S)
            outs.append(log_)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"--pt-rank {r} of {world} exited "
                                 f"{p.returncode}:\n{o[-6000:]}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def pt_reference(dev, cfg: dict) -> dict:
    """The one-rank run of ``cfg`` in this process (a one-rank NCCL
    group), each step timed; K1/K2/K3 counted; with MoE the first
    step's expert load."""
    import torch

    from theanompi_tpu_torch.models import Llama
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )

    counters = {"K1": flash_fwd_cuda, "K2": flash_bwd_dkv_cuda,
                "K3": flash_bwd_dq_cuda}
    steps = []
    train_iter = Llama.train_iter

    def timed(self, count, recorder):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_iter(self, count, recorder)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters.values())
    Llama.train_iter = timed
    grad_sq = {}
    exchange_update = grad_norm_probe(Llama, grad_sq)
    load = {}
    aux_from = expert_load_probe(Llama, load)
    try:
        out = bsp([dev.index], cfg, verbose=False)
    finally:
        Llama.train_iter = train_iter
        Llama._exchange_update = exchange_update
        Llama._aux_from_moments = aux_from
    res = {"losses": out["recorder"].train_losses, "step_s": steps,
           "grad_norms": {k: math.sqrt(v) for k, v in grad_sq.items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k: fn.launches for k, fn in counters.items()},
           "tc_launches": {k: fn.tc_launches for k, fn in counters.items()},
           "params_b": out["model"].n_params() / 1e9,
           "expert_load": load.get("f")}
    del out
    torch.cuda.empty_cache()
    return res


def pt_check(name: str, dtype: str, layout: dict, ranks: list, ref: dict,
             card: str, *, phase: str = "parallel_train", per_step=None,
             tokens: int | None = None, steps: int = PT_STEPS,
             later_rtol: float | None = None) -> dict:
    """Hold every rank of one layout's run to the one-rank run: the
    losses within ``PT_RTOL`` (and equal across the ranks), each leaf's
    first exchanged gradient norm within ``PT_GRAD_RTOL``, K1/K2/K3 at
    the formula's count on the dtype's route, no plain version and no
    SDPA on the path; its numbers (step ms, tokens/s, collectives,
    peak, the worst gradient norm) logged, then every failure raised
    together."""
    rtol = PT_RTOL[dtype]
    # the first step's loss (the forward alone) at rtol, the later ones
    # at later_rtol when given
    tols = [rtol] + [later_rtol or rtol] * (steps - 1)
    want_losses = ref["losses"]
    if tokens is None:
        tokens = PT_SEQ if dtype == "bfloat16" else SMALL["seq_len"]
    if per_step is None:
        def per_step(job):
            return pt_launches_per_step(layout, job["seq_rank"])
    fails = []
    norms = pt_grad_norms(ranks, name)
    grad_rel = {k: abs(norms[k] - w) / w
                for k, w in ref["grad_norms"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    if set(norms) != set(ref["grad_norms"]) \
            or not all(map(math.isfinite, grad_rel.values())) \
            or grad_rel[worst] > PT_GRAD_RTOL[dtype]:
        fails.append(f"gradient norms: {worst} at relative "
                     f"{grad_rel[worst]} of one rank's (> "
                     f"{PT_GRAD_RTOL[dtype]}); all: {grad_rel}")
    per_rank = []
    for r, rk in enumerate(ranks):
        job = rk["jobs"][name]
        losses = job["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
        if len(losses) != steps or not all(map(math.isfinite, losses)) \
                or any(e > t for e, t in zip(rel, tols)):
            fails.append(f"rank {r}: losses {losses} against one rank's "
                         f"{want_losses}: relative {rel} (> {tols})")
        want = {k: v * steps for k, v in per_step(job).items()}
        if job["launches"] != want:
            fails.append(f"rank {r} (seq rank {job['seq_rank']}): "
                         f"launches {job['launches']}, want {want}")
        if job["routes"] != routes_want(dtype, want):
            fails.append(f"rank {r}: launches, bf16 tensor-core, three-pass "
                         f"TF32 {job['routes']}, want "
                         f"{routes_want(dtype, want)}")
        if job["plain_calls"]:
            fails.append(f"rank {r}: plain versions or SDPA called "
                         f"{job['plain_calls']}")
        med = statistics.median(job["step_s"][1:])
        coll = {k: {"calls": len(v), "median_ms": statistics.median(v),
                    "total_ms_per_step": sum(v) / steps}
                for k, v in job["collective_ms"].items()}
        per_rank.append({"rank": r, "coords": job["coords"],
                         "losses": losses, "max_rel_vs_one_rank": max(rel),
                         "step_s": job["step_s"], "median_step_ms":
                         med * 1e3, "tokens_per_s": tokens / med,
                         "peak_gib": job["peak_gib"],
                         "params_b_rank": job["params_b_rank"],
                         "launches": job["launches"], "collectives": coll,
                         "expert_load": job.get("expert_load")})
    res = {"layout": name, "dtype": dtype, "config": layout,
           "one_rank_losses": want_losses, "rtol": tols,
           "grad_norm_worst": {"leaf": worst, "rel": grad_rel[worst],
                               "rtol": PT_GRAD_RTOL[dtype]},
           "ranks": per_rank}
    log(f"[{phase} {name} {dtype}] {json.dumps(res)} on {card}")
    if fails:
        raise AssertionError(f"{phase} {name} {dtype}: " + "; ".join(fails))
    return res


def pt_path_shapes(dtype: str) -> list:
    """((B, H, T, D), causal) of every K1-K3 launch shape on the
    parallel_train path in ``dtype``, with the arms that launch it: the
    one rank [H, T]; a tp = 2 rank [H/2, T]; a ring rank [H, T/2], its
    diagonal hop causal and the earlier block full; a Ulysses rank
    [H/2, T] (heads split by the all-to-all); a tp = 2 x sp = 2 ring
    rank [H/2, T/2]."""
    cfg = pt_config(dtype)
    h, t, d = cfg["n_heads"], cfg["seq_len"], cfg["dim"] // cfg["n_heads"]
    at: dict = {}
    arms = [("one rank", {})] + list(PT_PAIR.items()) + list(PT_QUAD.items())
    for name, lay in arms:
        tp, sp = lay.get("tp", 1), lay.get("sp", 1)
        ring = sp > 1 and lay.get("sp_mode") == "ring"
        shape = (cfg["batch_size"], h // tp // (1 if ring else sp),
                 t // sp if ring else t, d)
        for causal in ((True, False) if ring else (True,)):
            at.setdefault((shape, causal), []).append(name)
    return list(at.items())


def kernels_vs_plain(got: dict, q, k, v, do, lse, delta, causal: bool,
                     dtype: str) -> dict:
    """(max abs error, within ``TOL``) of each of ``got`` (``o``/``lse``
    from K1, ``dq``/``dk``/``dv`` from K3/K2 run against ``lse`` and
    ``delta``) against the plain versions evaluated in fp32 on the same
    inputs, a few heads at a time (they hold [B, h, T, T] f32
    scores)."""
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_reference,
        mha_reference_fwd,
    )

    b, h, t, _ = q.shape
    step = max(1, 2**29 // (b * t * k.shape[2]))
    worst = {n: (0.0, True) for n in got}
    for h0 in range(0, h, step):
        sl = (slice(None), slice(h0, h0 + step))
        qf, kf, vf, dof = (x[sl].float() for x in (q, k, v, do))
        ref = {}
        if "o" in got:
            ref["o"], ref["lse"] = mha_reference_fwd(qf, kf, vf,
                                                     causal=causal)
        ref["dq"], ref["dk"], ref["dv"] = flash_bwd_reference(
            qf, kf, vf, dof, lse[sl], delta[sl], causal=causal)
        for n, x in got.items():
            err, ok = compare(x[sl], ref[n],
                              "float32" if n == "lse" else dtype)
            worst[n] = (max(worst[n][0], err), worst[n][1] and ok)
        del ref, qf, kf, vf, dof
    return worst


def pt_kernel_checks(dev, records: dict, *, shapes=None,
                     phase: str = "parallel_train") -> dict:
    """K1, K2 and K3 against their plain versions at every shape of
    ``pt_path_shapes`` in bf16 (the tensor cores) and fp32 (three TF32
    passes), and
    K2/K3 against a GLOBAL (lse, delta): a ring rank's queries over two
    blocks (its diagonal causal, an earlier one full), the lse and o of
    their merge fed to K2/K3 for each block, as the ring's backward
    does; every failure raised together.  Returns the max abs errors,
    ``{dtype: {shape: {output: error}}}``, the shapes keyed by
    ``pt_shape_key``."""
    import torch

    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )

    gen = torch.Generator(device=dev).manual_seed(14)
    out, bad = {}, []
    ring = shapes is None
    shapes = shapes or pt_path_shapes

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def bwd(q, k, v, do, lse, delta, causal, sm):
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm)
        return {"dq": flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal,
                                        sm), "dk": dk, "dv": dv}

    def note(key, dtype, errs):
        out.setdefault(dtype, {})[key] = {n: e for n, (e, _) in
                                          errs.items()}
        if not all(ok for _, ok in errs.values()):
            bad.append(f"{dtype} {key}: {errs}")

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for (shape, causal), _ in shapes(dtype):
            q, k, v, do = (randn(shape, dt) for _ in range(4))
            sm = shape[-1] ** -0.5
            o, lse = flash_fwd_cuda(q, k, v, causal, sm)
            delta = (do.float() * o.float()).sum(-1)
            got = dict(bwd(q, k, v, do, lse, delta, causal, sm), o=o, lse=lse)
            note(pt_shape_key(shape, causal), dtype, kernels_vs_plain(got, q, k, v, do, lse, delta,
                                              causal, dtype))
            del q, k, v, do, o, lse, delta, got
        if not ring:
            continue
        # the ring's backward: the global residuals of a two-block merge
        (shape, _), _ = next(x for x in pt_path_shapes(dtype)
                             if "ring" in x[1])
        q, k0, v0, k1, v1, do = (randn(shape, dt) for _ in range(6))
        sm = shape[-1] ** -0.5
        o0, l0 = flash_fwd_cuda(q, k0, v0, True, sm)
        o1, l1 = flash_fwd_cuda(q, k1, v1, False, sm)
        lse = torch.logaddexp(l0, l1)
        o = (torch.exp(l0 - lse)[..., None] * o0.float()
             + torch.exp(l1 - lse)[..., None] * o1.float()).to(dt)
        delta = (do.float() * o.float()).sum(-1)
        for kb, vb, causal, which in ((k0, v0, True, "diagonal"),
                                      (k1, v1, False, "earlier")):
            got = bwd(q, kb, vb, do, lse, delta, causal, sm)
            note(f"{list(shape)} global lse, {which} block "
                 f"{'causal' if causal else 'full'}", dtype,
                 kernels_vs_plain(got, q, kb, vb, do, lse, delta, causal,
                                  dtype))
        del q, k0, v0, k1, v1, do, o0, o1, o, lse, delta, got
        torch.cuda.empty_cache()
    log(f"[{phase}] K1/K2/K3 against their plain versions at the "
        f"path's shapes (max abs error): {json.dumps(out)}")
    for key in ("K1", "K2", "K3"):
        for dtype, rk in (("bfloat16", key), ("float32", f"{key} fp32")):
            if rk in records:
                records[rk][f"{phase}_shapes"] = {
                    s: max(e[n] for n in e if n in {
                        "K1": ("o", "lse"), "K2": ("dk", "dv"),
                        "K3": ("dq",)}[key])
                    for s, e in out[dtype].items()
                    if key != "K1" or "o" in e}
    if bad:
        raise AssertionError(f"{phase}: kernels disagree with their "
                             f"plain versions: " + "; ".join(bad))
    return out


def pt_shape_key(shape, causal: bool) -> str:
    return f"{list(shape)} {'causal' if causal else 'full'}"


def pt_hop_kernels(dev, records: dict, errs: dict) -> None:
    """K1, K2 and K3 at the ring's full (non-causal) hop shape
    [1, 32, 4096, 128] bf16, timed beside their bounds, their plain
    versions and SDPA's forward and backward; ``errs`` are their errors
    against the plain versions at that shape (``pt_kernel_checks``)."""
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_reference,
        flash_fwd_cuda,
        mha_reference_fwd,
    )

    flush = torch.empty(256 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    shape = (1, 32, PT_SEQ // 2, 128)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    sm = shape[-1] ** -0.5
    o, lse = flash_fwd_cuda(q, k, v, False, sm)
    delta = (do.float() * o.float()).sum(-1)
    f_ms = time_ms(lambda: flash_fwd_cuda(q, k, v, False, sm), flush=flush)
    k2_ms = time_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                               False, sm), flush=flush)
    k3_ms = time_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                              False, sm), flush=flush)
    plain_f = time_ms(lambda: mha_reference_fwd(q, k, v, causal=False),
                      reps=5, flush=flush)
    plain_b = time_ms(lambda: flash_bwd_reference(q, k, v, do, lse, delta,
                                                  causal=False),
                      reps=5, flush=flush)
    sdpa_f = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                     flush=flush)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    sdpa_b = time_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), do,
                                                 retain_graph=True),
                     flush=flush)
    f_bound = bound(flash_ops("fwd", q.shape, causal=False),
                    4 * q.numel() * q.element_size() + lse.numel() * 4,
                    "bfloat16")
    k2_bound = bwd_bound("dkv", q, "bfloat16", causal=False)
    k3_bound = bwd_bound("dq", q, "bfloat16", causal=False)
    shape_s = f"{list(shape)} bfloat16 full (a ring hop off the diagonal)"
    for key, err, ms, plain, lib, (b_ms, b_by) in (
            ("K1", max(errs["o"], errs["lse"]), f_ms, plain_f, sdpa_f,
             f_bound),
            ("K2", max(errs["dk"], errs["dv"]), k2_ms, plain_b, sdpa_b,
             k2_bound),
            ("K3", errs["dq"], k3_ms, plain_b, sdpa_b, k3_bound)):
        rec = {"shape": shape_s, "max_abs_err": err, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by}
        log(f"{key} at the ring's full hop shape {shape_s}: "
            f"{json.dumps(rec)}")
        if key in records:
            records[key]["full_hop_shape"] = rec
    del flush


def run_parallel_train_phase(dev, records: dict, card: str) -> None:
    """Phase parallel_train: Llama training at tp = 2, sp = 2 (ring and
    Ulysses) and tp = 2 x sp = 2, ranks on card 0 over gloo, against the
    one-rank run from the same init (drawn whole from the seed, then
    sharded) and batches; each layout in fp32 at the small width (the
    fp32 kernels) and in bf16 at Llama-3-8B widths (the tensor cores);
    then K1/K2/K3 at the ring's full hop shape."""
    t0 = time.perf_counter()
    refs = {}
    for dtype in ("float32", "bfloat16"):
        refs[dtype] = pt_reference(dev, pt_config(dtype))
        log(f"[parallel_train one rank {dtype}] {json.dumps(refs[dtype])} "
            f"on {card}")
    arms = {}
    for world, layouts in ((2, PT_PAIR), (4, PT_QUAD)):
        jobs = [(f"{name}_{dtype}", pt_config(dtype, **layout))
                for name, layout in layouts.items()
                for dtype in ("float32", "bfloat16")]
        ta = time.perf_counter()
        ranks = pt_spawn(world, jobs)
        log(f"[parallel_train] {world} ranks on card 0: "
            f"{time.perf_counter() - ta:.1f} s")
        for name, layout in layouts.items():
            for dtype in ("float32", "bfloat16"):
                arms[f"{name}_{dtype}"] = pt_check(
                    f"{name}_{dtype}", dtype, layout, ranks, refs[dtype],
                    card)
    launches = {"K1": 0, "K2": 0, "K3": 0}
    fp32 = {"K1 fp32": 0, "K2 fp32": 0, "K3 fp32": 0}
    for key, res in arms.items():
        for rk in res["ranks"]:
            for k, n in rk["launches"].items():
                if res["dtype"] == "bfloat16":
                    launches[k] += n
                else:
                    fp32[f"{k} fp32"] += n
    for k, n in list(launches.items()) + list(fp32.items()):
        if k in records:
            add_launches(records[k], parallel_train=n)
    errs = pt_kernel_checks(dev, records)
    pt_hop_kernels(dev, records, errs["bfloat16"][pt_shape_key(
        (1, 32, PT_SEQ // 2, 128), False)])
    log(f"[parallel_train] {time.perf_counter() - t0:.1f} s")


# -- phase stack_train: pp > 1 and MoE experts at ep >= 1 ---------------------

#: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1,
#: params.json and config.json): SwiGLU experts, top-2 gates
#: renormalised, the design of the port's (and the JAX package's) MoE
MIXTRAL_8X7B = dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                    ffn_dim=14336, vocab=32000, seq_len=32768,
                    n_experts=8, moe_top_k=2)
ST_LAYERS = 2            # depth of the full-width arms (REDUCED)
ST_SEQ = 4096            # REDUCED
ST_STEPS = 3
ST_BATCH = {"bfloat16": 2, "float32": 4}   # global batch by dtype
# the two-process arms (run in turn in the same processes) and the
# four-process one; the full width runs the arms of ST_WIDE; "data" is
# the data axis (what the world leaves after pp x ep), which st_config
# takes out of the model's config
ST_PAIR = {"dp2": dict(data=2), "ep2": dict(ep=2), "pp2": dict(pp=2),
           "pp2_dense": dict(pp=2, n_experts=0)}
ST_QUAD = {"pp2_ep2": dict(pp=2, ep=2)}
ST_WIDE = ("ep2", "pp2")
# the bf16 MoE arms' losses after the first step against one rank's:
# MoE routes discretely, so the bf16 rounding of a layout's other GEMM
# shapes moves a few tokens' top-2 picks (layer 1's expert load f moved
# by 1.6e-4: ~3 of 16384 picks, on an H100), and Adam (lr·m/sqrt(v)) turns
# those tokens' gradient differences into whole updates: measured
# 1.19e-4 (pp = 2) and 1.29e-4 (ep = 2) at step 3, 1.2e-5 to 3.0e-5 at
# step 2 (1.5e-5 at step 1, held to PT_RTOL); the limit sits about 2x
# over the worst reading, below the per-step loss drift (~1.6e-3):
# planted, a skipped second update read 1.32e-3 and 1.33e-3 at step 3;
# expert gradients left undivided by ep read 6.3e-5 on the losses (Adam
# is scale-free) and 1.0 on the expert leaves' norms (PT_GRAD_RTOL)
ST_MOE_RTOL = 3e-4


def st_config(dtype: str, **layout) -> dict:
    """A stack_train run: Mixtral-8x7B widths at ``ST_LAYERS`` and seq
    ``ST_SEQ`` in bf16 (Adam, remat, capacity factor E/k = 4.0: nothing
    drops, as Mixtral routes; the JAX default aux coefficient 0.01), or
    the small model in fp32 with 4 experts, top-2, capacity factor 2.0
    (SGD at lr 0.5, which a wrongly scaled gradient would move); the
    global batch ``ST_BATCH[dtype]`` over the data replicas (expert x
    data), ``ST_STEPS`` steps, no val pass."""
    if dtype == "bfloat16":
        cfg = dict(MIXTRAL_8X7B, n_layers=ST_LAYERS, seq_len=ST_SEQ,
                   compute_dtype="bfloat16", optimizer="adam", lr=1e-4,
                   remat=True, xent_chunks="auto", seed=0,
                   capacity_factor=4.0, moe_aux_coef=0.01)
    else:
        cfg = dict(SMALL, optimizer="sgd", lr=0.5, remat=True,
                   n_experts=4, moe_top_k=2, capacity_factor=2.0)
    glob = ST_BATCH[dtype]
    layout = dict(layout)
    replicas = layout.get("ep", 1) * layout.pop("data", 1)
    cfg.update(batch_size=glob // replicas,
               n_train=ST_STEPS * glob, n_val=0, exch_strategy="ici32",
               **layout)
    return cfg


def st_launches_per_step(cfg: dict) -> dict:
    """K1/K2/K3 launches a rank makes a step: each stage runs its L/pp
    layers on each of the M + pp - 1 ticks (fill and drain included,
    as JAX's stages do), the forward twice under remat."""
    from theanompi_tpu_torch.models import Llama

    pp = cfg.get("pp", 1)
    ticks = (Llama(cfg, device="cpu").pp_microbatches + pp - 1
             if pp > 1 else 1)
    n = cfg["n_layers"] // pp * ticks
    return {"K1": 2 * n, "K2": n, "K3": n}


def st_path_shapes(dtype: str) -> list:
    """((B, H, T, D), causal) of every K1-K3 launch shape on the
    stack_train path in ``dtype``: a rank's batch [B/ep, H, T, D], or at
    pp > 1 a microbatch's [B/ep/M, H, T, D], all causal."""
    from theanompi_tpu_torch.models import Llama

    at: dict = {}
    arms = [("one rank", {})] + list(ST_PAIR.items()) + list(ST_QUAD.items())
    for name, lay in arms:
        if dtype == "bfloat16" and name not in ST_WIDE + ("one rank",):
            continue
        cfg = st_config(dtype, **lay)
        b = cfg["batch_size"]
        if cfg.get("pp", 1) > 1:
            b //= Llama(cfg, device="cpu").pp_microbatches
        shape = (b, cfg["n_heads"], cfg["seq_len"],
                 cfg["dim"] // cfg["n_heads"])
        at.setdefault((shape, True), []).append(name)
    return list(at.items())


def run_stack_train_phase(dev, records: dict, card: str) -> None:
    """Phase stack_train: Llama training with MoE at ep = 2, at pp = 2
    (MoE and dense) and at pp = 2 x ep = 2, ranks on card 0 over gloo,
    against the one-rank runs from the same init and batches; each arm
    in fp32 at the small width, ep = 2 and pp = 2 also in bf16 at
    Mixtral-8x7B widths; then K1/K2/K3 at the path's shapes."""
    t0 = time.perf_counter()
    refs = {}
    for dtype, moe in (("float32", True), ("float32", False),
                       ("bfloat16", True)):
        cfg = st_config(dtype, **({} if moe else {"n_experts": 0}))
        refs[(dtype, moe)] = pt_reference(dev, cfg)
        log(f"[stack_train one rank {dtype}{'' if moe else ' dense'}] "
            f"{json.dumps(refs[(dtype, moe)])} on {card}")
    arms = {}
    for world, layouts in ((2, ST_PAIR), (4, ST_QUAD)):
        jobs = [(f"{name}_{dtype}", st_config(dtype, **layout))
                for dtype in ("float32", "bfloat16")
                for name, layout in layouts.items()
                if dtype == "float32" or name in ST_WIDE]
        ta = time.perf_counter()
        ranks = pt_spawn(world, jobs)
        log(f"[stack_train] {world} ranks on card 0: "
            f"{time.perf_counter() - ta:.1f} s")
        for job, cfg in jobs:
            dtype = cfg["compute_dtype"]
            arms[job] = pt_check(
                job, dtype, layouts[job.rsplit("_", 1)[0]], ranks,
                refs[(dtype, bool(cfg["n_experts"]))], card,
                phase="stack_train", steps=ST_STEPS,
                per_step=lambda _, cfg=cfg: st_launches_per_step(cfg),
                tokens=cfg["seq_len"] * ST_BATCH[dtype],
                later_rtol=(ST_MOE_RTOL if dtype == "bfloat16"
                            and cfg["n_experts"] else None))
    launches = {"K1": 0, "K2": 0, "K3": 0}
    fp32 = {"K1 fp32": 0, "K2 fp32": 0, "K3 fp32": 0}
    for res in arms.values():
        for rk in res["ranks"]:
            for k, n in rk["launches"].items():
                if res["dtype"] == "bfloat16":
                    launches[k] += n
                else:
                    fp32[f"{k} fp32"] += n
    for k, n in list(launches.items()) + list(fp32.items()):
        if k in records:
            add_launches(records[k], stack_train=n)
    pt_kernel_checks(dev, records, shapes=st_path_shapes,
                     phase="stack_train")
    log(f"[stack_train] {time.perf_counter() - t0:.1f} s")


def ptxas_kernels(report: str) -> list[dict]:
    """Each entry function of an ``nvcc -Xptxas -v`` report: its
    (mangled) name, registers and spill bytes (stores + loads)."""
    out = []
    for blk in report.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        out.append({
            "name": blk.split("'", 1)[0],
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                            if spill else None),
        })
    return out


TC_OCCUPANCY = {"flash_fwd_tc_kernel": ("flash_fwd",
                                        "tm_flash_fwd_tc_occupancy"),
                "flash_fwd_tf32x3_kernel": (
                    "flash_fwd", "tm_flash_fwd_tf32x3_occupancy"),
                "flash_bwd_dkv_tc_kernel": ("flash_bwd",
                                            "tm_flash_bwd_dkv_tc_occupancy"),
                "flash_bwd_dq_tc_kernel": ("flash_bwd",
                                           "tm_flash_bwd_dq_tc_occupancy"),
                "flash_bwd_dkv_tf32x3_kernel": (
                    "flash_bwd", "tm_flash_bwd_dkv_tf32x3_occupancy"),
                "flash_bwd_dq_tf32x3_kernel": (
                    "flash_bwd", "tm_flash_bwd_dq_tf32x3_occupancy"),
                "paged_split_tc_kernel": (
                    "paged_attend", "tm_paged_split_tc_occupancy"),
                "paged_split_tf32x3_kernel": (
                    "paged_attend", "tm_paged_split_tf32x3_occupancy")}


def tc_report(reports: dict) -> dict:
    """Per tensor-core kernel (bf16, and the fp32 K1-K4 in three TF32
    passes; K4's split kernels) and head dim: ptxas's registers and
    spills, the dynamic shared memory and the CTAs the runtime fits on
    one SM."""
    import ctypes

    from theanompi_tpu_torch.kernels import _build

    out = {}
    for rep in reports.values():
        for e in ptxas_kernels(rep):
            m = re.search(r"((?:flash|paged)_[a-z_]+_(?:tc|tf32x3)_kernel)"
                          r"ILi(\d+)E", e["name"])
            if m is None:
                continue
            kernel, d = m.group(1), int(m.group(2))
            lib_name, fn_name = TC_OCCUPANCY[kernel]
            lib = _build.load(lib_name)
            smem, ctas = ctypes.c_int(), ctypes.c_int()
            _build.check(lib, getattr(lib, fn_name)(
                d, ctypes.byref(smem), ctypes.byref(ctas)), fn_name)
            out.setdefault(kernel, {})[d] = {
                "registers": e["registers"], "spill_bytes": e["spill_bytes"],
                "smem_bytes": smem.value, "ctas_per_sm": ctas.value}
    return out


# -- main -------------------------------------------------------------------

PHASE_S: dict = {}


def phase_start(name: str, t_start: float) -> None:
    """Log the phase's start; the previous phase's seconds go to
    ``PHASE_S`` (printed at the end)."""
    now = time.perf_counter() - t_start
    if PHASE_S:
        last = next(reversed(PHASE_S))
        PHASE_S[last] = now - PHASE_S[last]
    PHASE_S[name] = now
    log(f"== phase {name} at {now:.1f} s")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES} (default: all)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of the full-width models (default: 8; "
                    "8 serving_ext, 2 serving_fleet and serving_tp)")
    # rank 1 of the serving_tp phase, started by rank 0
    ap.add_argument("--tp-rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tp-init", default=None, help=argparse.SUPPRESS)
    # a rank of the exchange phase's two-rank arm, started by the phase
    ap.add_argument("--exchange-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--exchange-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--exchange-dir", default=None, help=argparse.SUPPRESS)
    # a rank of the parallel_train phase's arms, started by the phase
    ap.add_argument("--pt-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--pt-world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--pt-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pt-jobs", default=None, help=argparse.SUPPRESS)
    # a rank of the resilience phase's elastic arm, started by its
    # supervisor's rank-group runner
    ap.add_argument("--resilience-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--resilience-world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--resilience-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resilience-spec", default=None, help=argparse.SUPPRESS)
    # a process of the resilience phase's supervised runs
    # (journal_worker), which bsp_worker.worker_main parses
    ap.add_argument("--spec-json", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world-size", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    ns.phases = [p for p in ns.phases.split(",") if p]
    bad = set(ns.phases) - set(PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}; known: {PHASES}")
    return ns


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ns = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "theanompi_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: theanompi_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    # one bytecode cache, inside the checkout, for every process the run
    # starts: an interpreter set to write none compiles torch's modules
    # again in each child (on the H100 host, ~2.5 s a process, most of it
    # in the imports of the first activation checkpoint)
    cache = str(ROOT / "build" / "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix, sys.dont_write_bytecode = cache, False
    sys.path.insert(0, str(ROOT))
    if ns.spec_json is not None:
        journal_worker()
        return 0
    if ns.tp_rank:
        serving_tp_follower(torch.device("cuda", 0), ns.tp_init,
                            ns.layers or TP_LAYERS)
        return 0
    if ns.exchange_rank is not None:
        exchange_rank(torch.device("cuda", 0), ns.exchange_rank,
                      ns.exchange_init, ns.exchange_dir)
        return 0
    if ns.pt_rank is not None:
        pt_rank(torch.device("cuda", 0), ns.pt_rank, ns.pt_world,
                ns.pt_init, json.loads(ns.pt_jobs))
        return 0
    if ns.resilience_rank is not None:
        resilience_rank(torch.device("cuda", 0), ns.resilience_rank,
                        ns.resilience_world, ns.resilience_init,
                        json.loads(ns.resilience_spec))
        return 0
    from theanompi_tpu_torch.kernels import _build
    from theanompi_tpu_torch.models import LLAMA3_8B, Llama
    from theanompi_tpu_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
    from theanompi_tpu_torch.serving import LlamaDecoder, PagedLlamaDecoder
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(f"phases: {ns.phases}, layers: {ns.layers or 'default'}")
    log("reduced: " + json.dumps(REDUCED))
    (ROOT / "build").mkdir(exist_ok=True)

    # phase 1: build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {len(reports)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        ks = ptxas_kernels(rep)
        log(f"  {name}: {len(ks)} kernels, at most "
            f"{max(k['registers'] for k in ks)} registers, "
            f"{sum(k['spill_bytes'] for k in ks)} bytes spilled")
        for k in ks:
            if k["spill_bytes"]:
                log(f"    {k['name']}: {k['spill_bytes']} bytes spilled")
    tc = tc_report(reports)
    for kernel, by_d in tc.items():
        for d, r in sorted(by_d.items()):
            log(f"  {kernel} D={d}: {json.dumps(r)}")

    records = {}
    if "kernels" in ns.phases:
        phase_start("kernels", t_start)
        # phase 2: kernels against their plain versions
        # 1 GiB: the device takes ~0.3 ms to overwrite it, longer than
        # the host needs to enqueue any kernel's call
        flush = torch.empty(256 * 2**20, dtype=torch.int32, device=dev)
        records.update(check_flash(dev, flush))
        records.update(check_flash_bwd(dev, flush))
        records["K1"]["sm_scale_signs"] = check_sm_scale(dev)
        records.update(check_paged(dev, flush))
        records["rms_norm"] = check_rms_norm(dev, flush)
        del flush
        torch.cuda.empty_cache()
        for k, kernel in (("K1", "flash_fwd_tc_kernel"),
                          ("K2", "flash_bwd_dkv_tc_kernel"),
                          ("K3", "flash_bwd_dq_tc_kernel"),
                          ("K1 fp32", "flash_fwd_tf32x3_kernel"),
                          ("K2 fp32", "flash_bwd_dkv_tf32x3_kernel"),
                          ("K3 fp32", "flash_bwd_dq_tf32x3_kernel"),
                          ("K4", "paged_split_tc_kernel"),
                          ("K4 fp32", "paged_split_tf32x3_kernel")):
            records[k]["ptxas_d128"] = tc.get(kernel, {}).get(128)
        # the fp32 routes run on the small fp32 models: count them there
        fp32_routes = {"K1 fp32": flash_fwd_cuda,
                       "K2 fp32": flash_bwd_dkv_cuda,
                       "K3 fp32": flash_bwd_dq_cuda}
        by_path = {k: {} for k in (*fp32_routes, "K4 fp32")}
        for path, run in (("reference_serving_fp32", check_reference),
                          ("reference_training_fp32",
                           check_training_reference)):
            reset_counts(*fp32_routes.values(), paged_attend_cuda)
            run(dev)
            for k, fn in fp32_routes.items():
                key = k.split()[0]
                if route_counts(fn) != routes_want(
                        "float32", {key: fn.launches})[key]:
                    raise AssertionError(f"{path}: fp32 {fn.__name__} "
                                         f"launches, bf16 tensor-core, "
                                         f"three-pass TF32 "
                                         f"{route_counts(fn)}")
                if fn.launches:
                    by_path[k][path] = fn.launches
            if route_counts(paged_attend_cuda) != routes_want(
                    "float32", {"K4": paged_attend_cuda.launches})["K4"]:
                raise AssertionError(f"{path}: fp32 K4 launches, bf16 "
                                     f"tensor-core, three-pass TF32 "
                                     f"{route_counts(paged_attend_cuda)}")
            if paged_attend_cuda.launches:
                by_path["K4 fp32"][path] = paged_attend_cuda.launches
        for k, paths in by_path.items():
            if not paths:
                raise AssertionError(f"{k}: never launched by the fp32 "
                                     f"reference runs")
            records[k]["launches"] = sum(paths.values())
            records[k]["launches_by_path"] = paths
            log(f"{k} ({records[k]['name']}) launches {paths}")

    if "serving" in ns.phases:
        phase_start("serving", t_start)
        # phases 3-4: the serving paths at Llama-3-8B width
        cfg = dict(LLAMA3_8B, compute_dtype="bfloat16", seed=0,
                   n_layers=ns.layers or SERVING_LAYERS)
        t0 = time.perf_counter()
        model = Llama(cfg, device=dev)
        model.params                   # drawn at first use: time it here
        torch.cuda.synchronize()
        log(f"model: Llama {cfg} with {model.n_params() / 1e9:.3f} B "
            f"params, random init in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        prompts, shared = make_requests(model.vocab)
        warm = [prompts[0][:16]]

        dec = LlamaDecoder(model, max_slots=8, max_seq=2048)
        log(f"[v1] cache {dec.kv_cache_bytes() / 2**30:.2f} GiB")
        serve(dec, warm, max_tokens=2, seeds=[0])              # warm-up
        v1 = run_serving("v1", dec, prompts, (0, 5, 11), flash_fwd_cuda)
        profile_decode("v1", dec, prompts)
        del dec

        dec = PagedLlamaDecoder(model, max_slots=8, max_seq=2048,
                                block_size=16, prefill_chunk=64)
        log(f"[paged] pools {dec.kv_cache_bytes() / 2**30:.2f} GiB")
        serve(dec, warm, max_tokens=2, seeds=[0], prefix_caching=False)
        # the first system-prompt request prefills (cold) ahead of the
        # queue; the other three queue behind the 12, so they arrive
        # after its blocks are cached and adopt them
        run = run_serving("paged", dec, shared[:1] + prompts + shared[1:],
                          (0, 1, 13, 15), paged_attend_cuda)
        hits = run["stats"]["prefix_cache"]["n_hits"]
        log(f"[paged] prefix-cache hits {hits}")
        if hits < 1:
            raise AssertionError("paged: no prefix-cache hit")
        profile_decode("paged", dec, prompts)
        profile_decode_scopes(dec, prompts)
        del dec, model
        log(f"peak device memory (serving) "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        torch.cuda.empty_cache()
        if "K1" in records:
            records["K1"]["launches"] = v1["launches"]
            records["K1"]["launches_by_path"] = {"serving_v1":
                                                 v1["launches"]}
            records["K4"]["launches"] = run["launches"]
            records["K4"]["launches_by_path"] = {"serving_paged":
                                                 run["launches"]}
            add_launches(records["rms_norm"],
                         serving_v1=v1["norm_launches"],
                         serving_paged=run["norm_launches"])

    ext_rate = None
    if "serving_ext" in ns.phases:
        phase_start("serving_ext", t_start)
        # phase 5: speculation, handoffs, tracing, the tokenizer
        count_fp32_k4(records, "serving_ext_reference",
                      check_serving_ext_reference, dev)
        ext_rate = run_serving_ext(dev, ns.layers, records)
        log(f"peak device memory (serving_ext) "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    if "serving_fleet" in ns.phases:
        phase_start("serving_fleet", t_start)
        # phase 6: the router, the replicas, the autoscaler
        count_fp32_k4(records, "serving_fleet_reference",
                      check_fleet_reference, dev)
        torch.cuda.reset_peak_memory_stats()
        run_serving_fleet(dev, ns.layers, records, ext_rate)
        log(f"peak device memory (serving_fleet) "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    if "serving_tp" in ns.phases:
        phase_start("serving_tp", t_start)
        # tp = 2 serving, two ranks on card 0
        torch.cuda.reset_peak_memory_stats()
        run_serving_tp(dev, ns.layers or TP_LAYERS, records)
        log(f"peak device memory (serving_tp, rank 0) "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    if "training" in ns.phases:
        phase_start("training", t_start)
        # phase 7: BSP training at Llama-3-8B widths, then its profile
        from theanompi_tpu_torch.utils import Recorder

        counters = {"K1": flash_fwd_cuda, "K2": flash_bwd_dkv_cuda,
                    "K3": flash_bwd_dq_cuda}
        # the group outlives the run, so the profile can take more steps
        init_group(dev)
        res, model = run_training(dev, ns.layers or 8, counters,
                                  profile=True)
        check_train_trajectory("training", res)
        res["profile"] = profile_training(model)
        check_profile_busy("training", res)
        check_step_flops("training", model, res)
        # one staged step's copies and syncs, beside the cached chunk's
        res["traffic_per_step"] = host_traffic(
            lambda: model.train_iter(0, Recorder(verbose=False)))
        # the dispatch count sees the stager's copies: it can fire
        t = res["traffic_per_step"]
        if not t["staged_bytes"] or t["h2d_op_bytes"] != t["staged_bytes"]:
            raise AssertionError(f"training: the staged step's copies at "
                                 f"dispatch are not the stager's: {t}")
        TRAINED["ici32"] = res
        del model
        torch.cuda.empty_cache()
        for k in ("K1", "K2", "K3"):
            if k in records:
                add_launches(records[k], training=res["launches"][k])
        # the device-resident chunk and selective remat
        run_training_arms(dev, ns.layers or 8, counters, records)
        destroy_group()
        torch.cuda.empty_cache()

    if "exchange" in ns.phases:
        phase_start("exchange", t_start)
        # zero1, the compressed wire, .shards and its reshard, the codec
        run_exchange_phase(dev, ns.layers or 8, records)

    if "parallel_train" in ns.phases:
        phase_start("parallel_train", t_start)
        # tp = 2, sp = 2 ring and Ulysses, tp = 2 x sp = 2 on card 0
        run_parallel_train_phase(dev, records, card)

    if "stack_train" in ns.phases:
        phase_start("stack_train", t_start)
        # pp = 2, MoE at ep = 2, pp = 2 x ep = 2 on card 0
        run_stack_train_phase(dev, records, card)

    if "cnn" in ns.phases:
        phase_start("cnn", t_start)
        # phase 8: the image-classifier path (no TPU kernel on it)
        run_cnn_phase(dev)

    if "async" in ns.phases:
        phase_start("async", t_start)
        # phase 9: EASGD and GoSGD in one process (no TPU kernel on it)
        run_async_phase(dev, (flash_fwd_cuda, flash_bwd_dkv_cuda,
                              flash_bwd_dq_cuda, paged_attend_cuda))

    if "async_dist" in ns.phases:
        phase_start("async_dist", t_start)
        # phase 10: EASGD and GoSGD across processes (no TPU kernel on it)
        run_async_dist_phase(dev)

    if "resilience" in ns.phases:
        phase_start("resilience", t_start)
        # phase 11: the supervisor, the drills, the elastic resume
        run_resilience_phase(dev, records)

    # phase 12: the kernels line, the card, the result
    log(json.dumps({"kernels": [
        records[k] for k in ("K1", "K2", "K1 fp32", "K2 fp32", "K3",
                             "K3 fp32", "K4", "K4 fp32", "rms_norm")
        if k in records and "name" in records[k]]}))
    phase_start("end", t_start)
    PHASE_S.pop("end")
    log("phase seconds " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_S.items()}))
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
