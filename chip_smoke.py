#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Requires CUDA and prints the card's name and power limit, then runs the
phases (each failure exits non-zero and prints no result line):
  build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
            (one nvcc per source, in parallel) and print the build time of
            each source and ptxas statistics of each kernel.
  kernels — hold each kernel against its plain PyTorch version on the card
            at its path's shapes, and time kernel, plain version and, where
            one PyTorch call computes the same function, that call (a
            yardstick the port never calls) with CUDA events:
            flash-attention at granite-8b's heads (H 32, KV 8, D 128), at
            recurrentgemma-2b's (H 10, KV 1, D 256, window 2048, also at
            S=4096 > window), at stablelm-3b's (H 32, KV 32, D 80), at
            qwen3-moe-30b-a3b's (H 32, KV 4, D 128), at kimi-k2-1t-a32b's
            (H 64, KV 8, D 112), at chatglm3-6b's (H 32, KV 2, D 128), at
            starcoder2-3b's (H 24, KV 2, D 128, window 4096, S=4096 and
            8192), at phi-3-vision-4.2b's (H 32, KV 32, D 96) and at
            musicgen-large's (H 32, KV 32, D 64), f32 (the FMA route) and
            bf16 (the wgmma route: each bf16 row's route and, by the
            profiler, its kernel's name), with TFLOP/s, against
            ``scaled_dot_product_attention``; flash-attention's backward
            kernel at the two train cells' shapes (granite-8b B=2,
            S=4096; starcoder2-3b S=8192, window 4096), bf16: the
            forward's log-sum-exp against the plain one's, dq, dk, dv
            against the op's plain backward on the same inputs, three CUDA
            kernels a call, timed against the plain backward and SDPA's
            backward; flash-decode at granite-8b's
            heads (B=1 at pos 0, 17, 63 and 4095; B=8 at pos 4095; the
            tune path's B=8, Smax=2048 at pos 0 and 1024), at
            recurrentgemma-2b's (G=10, D=256) and at the two MoE archs'
            and the four dense archs' heads (B=1, pos 63), with the CUDA
            kernels of one call (one) and the kernel's plan (heads per CTA,
            slices, CTAs per slice); rglru at (1, 2048, 2560), an odd S,
            S=4096 and slow decay (log_a ~ -1e-4), with the device work of
            one call (a memset and one kernel); mlstm at (1, 4, 2048,
            384) against the chunkwise plain version at three chunks and the
            step-recurrent oracle, and at S=4096 (times, the CUDA kernels of
            one call and its peak memory); rmsnorm at (2048, 2560), f32 and
            bf16, against ``F.rms_norm``.  Beside each CUDA-event time
            (``ms``, one call between two events) the device time of the
            kernel and of the library call (``device_ms``: torch.profiler,
            the device work of one call, mean over 20), and for the small
            kernels the host time of one call (``host_ms``).
  prefill — granite-8b at full width and depth, bf16, seeded random
            weights: ``make_prefill`` under a ``kernel="cuda"`` plan at
            B=1, S=2048 (finite logits; flash-attention launch count);
            then at full width cut to 2 layers, the same prefill under the
            ``"plain"`` plan, compared within a stated bf16 tolerance.
  serve   — ``ServeEngine`` (capacity 8, cache_len 2048, ``"cuda"`` plan)
            on 8 seeded requests of ~8 prompt tokens (``SERVE_PROMPT``)
            and 8 new tokens (``SERVE_NEW``):
            every request completes, the batched run equals the
            ``max_active=1`` run token for token, and the admission prefill
            went through flash-decode.
  trace   — torch.profiler over three admission decode steps (B=1) and
            three batched steps (B=8): wall and device-busy time per step,
            and the top operations by device and by host time.
  prefill-recurrent — granite's weights are freed; recurrentgemma-2b and
            xlstm-125m at full width and depth, bf16, seeded random
            weights, B=1, S=2048, ``"cuda"`` plan: finite logits and exact
            launch counts (rglru 18 and flash-attention 8; mlstm 9); then
            the ``"cuda"`` plan against the ``"plain"`` plan: recurrentgemma
            cut to one rec, rec, attn group, bf16; xlstm at full depth,
            pointwise in f32 (same weights; beside it, readings of a sound
            pair and of a lower-precision control), and on the mean gap in
            bf16.
  serve-recurrent — ``ServeEngine`` for each recurrent arch at full depth
            (capacity 8, ``"cuda"`` plan): on 8 seeded requests of ~8
            prompt tokens and 8 new tokens, every request completes and
            the batched streams equal the sequential ones; then a long
            load, 12 requests on the 8 slots, eight of them ~16 prompt
            tokens and 2040 new for recurrentgemma (past its 2048-token
            window), 128 new for xlstm (no window),
            on each arch cut to its first pattern of block kinds
            (recurrentgemma's rec, rec, attn group; xlstm's mlstm x 3,
            slstm):
            tok/s, peak memory, every request complete, a repeated request
            in a recycled slot gives the same stream; for recurrentgemma,
            decode past the window held to the forward in f32 (one group);
            then the same profile of decode steps as the trace phase.
  prefill-moe — every earlier model's weights freed; qwen3-moe-30b-a3b at
            full width and depth (48 attn_moe layers, 128 experts top-8,
            30.53 B parameters, 56.9 GiB in bf16), seeded random weights,
            ``make_prefill`` at B=1, S=2048, ``"cuda"`` plan: wall ms, peak
            memory, finite logits, exactly 48 flash-attention launches, and
            the share of (token, slot) assignments dropped at capacity
            C=160; then cut to 2 layers (views), the ``"cuda"`` plan
            against the ``"plain"`` plan (see MOE_AGREE_MIN): bf16, the
            expert-set agreement and the logits with the plain plan's
            routing replayed; f32 (a cast copy), pointwise.  Then
            kimi-k2-1t-a32b at full width cut to its dense layer and one
            MoE layer (head_dim 112, 384 experts), B=1, S=1024: 2
            flash-attention launches, the same bf16 comparison, and f32 at
            the dense layer.
  serve-moe — ``ServeEngine`` on qwen3-moe-30b-a3b at full depth
            (capacity 8, cache_len 2048, ``"cuda"`` plan), 8 seeded
            requests of 2-4 prompt tokens and 6 new: every request
            completes, batched == sequential token for token, flash-decode
            launches == 48 x prompt tokens; then the profile of decode
            steps.
  dense   — every earlier model's weights freed; chatglm3-6b, starcoder2-3b,
            phi-3-vision-4.2b and musicgen-large, one at a time, at full
            width and depth, bf16, seeded random weights: ``make_prefill``
            at B=1, S=2048, ``"cuda"`` plan, tokens or (phi-3-vision,
            musicgen: the stub frontends) ``embeds`` as the pipeline draws
            them: wall ms, peak memory, finite logits, flash-attention
            launches == layers (starcoder2-3b again at S=8192, past its
            4096 window); cut to 2 layers (views), the ``"cuda"`` plan
            against the ``"plain"`` plan (from embeds: in f32, and in bf16
            against the f32 run, see EMBEDS_BF16_ERR_RATIO);
            ``ServeEngine`` (capacity 8, cache_len 2048) on 8 requests of
            3-5 prompt tokens and 6 new:
            batched == sequential, flash-decode launches == layers x
            prompt tokens (0 for starcoder2-3b, whose windowed decode is
            plain, as the reference's).  Then phi-3-vision-4.2b cut to 2
            layers trains from ``embeds`` (B=1, S=2048, remat "dots"):
            step-0 grads of the "cuda" plan against the "plain" plan.
  train   — the training path, ``"cuda"`` plans, seeded random weights,
            ``SyntheticLM`` batches: granite-8b at full width cut to 8
            layers (bf16, f32 AdamW state, B=1, S=4096, remat="dots"):
            step-0 grads of the "cuda" plan against the "plain" plan per
            leaf (relative L2 error, every leaf's grad > 0; first at one
            f32 layer, the FMA route, then bf16), then 4 steps of
            ``make_train_step`` (loss, step ms, tokens/s, peak memory,
            flash-attention launches a step: a forward and a recompute per
            layer) and the time of one layer's flash-attention backward
            and of one AdamW update; recurrentgemma-2b's first group (rec,
            rec, attn) at full width, B=1, S=2048, no remat: the same
            grads gate and two steps (rglru and windowed flash-attention
            at D=256); qwen3-moe-30b-a3b at full width cut to 2 layers,
            B=1, S=4096, remat "dots", f32 AdamW state: the grads gate (f32,
            then bf16; the cuda plan's run replays the plain plan's
            routing), every leaf's grad > 0, the router's included, then
            two steps (loss, aux loss, step ms, peak memory, 4
            flash-attention launches a step); xlstm-125m at full width and depth through
            ``launch/train.py`` (B=8, S=256, a "cuda" plan file, remat
            "dots"): 2 steps straight, then 1, a restart from the latest
            checkpoint and 1 more, whose losses must equal the straight
            run's bit for bit (mlstm 18 launches a step).
  sweep   — the ComPar sweep (``core/tuner.py``), three sweeps, one JSON
            line each (``{"sweep": "A" | "B" | "C", ...}``).  A: the
            quickstart's path in-process (``repro_torch.examples.
            quickstart.main``): granite-8b at full width cut to 8 layers,
            B=1, S=4096, providers tensor_par and fsdp (at most one flag),
            remat {none, dots} x kernel {plain, cuda}, wall-clock (CUDA-event
            medians), then 3 train steps with the fused plan.  Gates: no
            row left pending; the plan is ``fuse`` of the DB's rows and its
            predicted total the sum of the chosen rows' scores; a second
            tuner in Continue mode scores nothing and fuses the same plan;
            allocated memory after the sweep and the steps within 64 MiB of
            before; finite losses and flash-attention launches a step as
            the plan's stack clause says (16 under cuda/dots, 8 under
            cuda/none, 0 under plain).  B: recurrentgemma-2b at full width
            and depth, prefill B=1, S=2048, kernel {plain, cuda}, remat none:
            each cuda stack job launches rglru and flash-attention (D=256)
            once a layer a call, each plain job neither.  C: the dry run
            (fake tensors, H100 constants) over A's space: predicted terms
            beside A's medians, and ``audit_soundness`` clean.
  tune    — the tuned-plan loop, one JSON line each (``{"tune": ...}``).
            machine: ``core/machine.py`` ``load_or_calibrate`` with the
            full CUDA ladder (bf16 and f32 products up to 8192 square, a
            1 GiB stream), its readings held within (0, 1.05] of the data
            sheet (989 TFLOP/s bf16, 67 f32, 3.35 TB/s) and bf16 >= 0.3,
            HBM >= 0.5 of it; a second call loads it from the cache.
            autotune: ``sweep(kernel_space="auto", kernel_top_k=2)``,
            wall clock, on granite-8b 8 layers (B=1, S=4096, train),
            recurrentgemma-2b (prefill, S=2048) and xlstm-125m (prefill,
            S=512): each op's
            variant table; each cuda measurement launches its kernel once
            a call, each plain one none, an op's cuda keys carry one
            outcome, each fused schedule is among its segment's
            survivors, no row fails, and a second sweep on the DB times
            nothing.  calibrated: sweep C with ``machine=`` the profile,
            predicted / measured beside the constant model's, its cache
            tag and rows apart from the constant model's.  lint: A's space
            as a dry run under "warn" and "off" (same rows, byte-identical
            plan), and under "strict" a microbatches=2 point at B=1 whose
            rows are settled "static" and launch nothing.  registry:
            granite-8b at full width and depth swept at its serving shape
            (capacity 8, cache 2048) with the kernel axis into a registry,
            then ``launch/serve.py --registry-db`` serves 8 requests of
            ~4 prompt tokens and 4 new
            (``plan=registry``, batched == sequential, flash-decode 36 x
            prompt tokens under a cuda plan); a lookup at capacity 4
            resolves to ``registry~decode:2048x8``.  The autotuner's top
            2 counts programs: each segment's survivors hold the tied cuda
            keys and a plain schedule; the line gives the fused stack and
            its outer median beside sweep A's plain/none.
  backends — the process and remote scoring backends
            (``core/backends/``), one JSON line each (``{"backends": "a"
            ... "e", ...}``), on stablelm-3b at full width cut to 2 layers,
            train, B=2 at S=2048, the JSON example's providers and
            microbatches {1, 2} with remat {none, dots} x kernel {plain,
            cuda}.  a: the dry run (1 layer) on 2 process workers against
            2 threads, the same rows and plan byte for byte.  b: the wall
            clock in process (asked for 2 workers, clamped to 1) against
            an in-process sequential sweep: every row done, the worker's
            kernel launches (carried back at its shutdown) equal the
            in-process run's, flash-attention at D=80 above 0.  c: a
            FaultPlan kills the worker while it times the cuda stack job:
            requeued to a fresh worker and done (the cell at 8 layers,
            so that the job still times when the kill comes), the card's
            free memory
            back within 64 MiB after close(), the parent's CUDA sound.  d:
            ``python -m repro_torch.core.backends.server --workers 1`` as
            a subprocess: a client sweep (1 layer), all rows done; a
            second client with a fresh DB scores nothing server-side, same
            plan; a third through a seeded ChaosProxy, same plan; the
            server killed, a sweep with remat "full" added and
            ``fallback="process"`` re-scores exactly the rows its cache
            lacked.  e: ``python -m repro_torch.examples.compar_sweep_json
            --backend process --layers 1``, the reference's spec (block_q
            16) with kernel {plain, cuda}: rc 0, no failed row, the
            Continue run scores nothing; and
            ``python -m repro_torch.examples.train_e2e --full --steps 4``
            (finite losses, resumed from step 2).
  mesh    — the port on a ``torch.distributed`` ``DeviceMesh``: a
            world-size-1 NCCL group and a (1, 1) ``data x model`` mesh
            (NCCL puts no two ranks on one card), one JSON line per part
            (``{"mesh": "group" | "prefill" | "serve" | "a2a" |
            "shardmap" | "train" | "sweep" | "dryrun", ...}``).  prefill: granite-8b at full width and depth
            placed by the ``tensor_par`` and then the ``fsdp`` plan's rules
            (leaves counted by placement), B=1, S=2048, ``"cuda"`` plan:
            logits held to the meshless run's (PREFILL_ATOL/RTOL),
            exactly 36 flash-attention launches.  serve: a meshed
            ``ServeEngine`` on 8 requests of ~3 prompt tokens and 4 new:
            batched == sequential, exactly 36 flash-decode launches per
            prompt token.  a2a: qwen3-moe-30b-a3b at full width cut to 4
            layers, prefill B=1, S=2048 under ``expert_par`` with
            ``moe_dispatch="a2a"`` against the same weights meshless and
            sorted (the expert-set agreement, a reading; the logits with
            the sorted routing replayed, PREFILL_ATOL/RTOL; 4
            flash-attention launches), then 2 layers' step-0 grads in f32
            (TRAIN_GRAD_REL_L2).  shardmap: one granite-8b attention layer,
            B=8, a 2048 cache, 64 positions of ``decode_shardmap`` (rules
            with ``kv_seq`` on ``model``) against the meshless flash-decode
            path: bf16 tolerance, caches equal, no flash-decode launch on
            the sharded side.  dryrun: ``python -m
            repro_torch.launch.dryrun --device cuda`` in three subprocesses
            at once (a fake group cannot share a process with the NCCL
            group): granite-8b decode_32k on (16, 16) and (2, 16, 16) under
            the default plan and on (16, 16) with ``decode_shardmap``,
            qwen3-moe-30b-a3b decode_32k with the a2a dispatch; each
            cell's status and collective bytes by kind, the granite cells
            held to DRYRUN_GATHER_MIN_BYTES (without) and
            DRYRUN_DSM_MAX_BYTES (with).  train: granite-8b cut to 2 layers, S=4096,
            ``tensor_par``, remat dots, step-0 grads on the mesh against
            meshless per leaf (TRAIN_GRAD_REL_L2, f32 at 1 layer, bf16 at
            2), then two AdamW steps on the placed params.  sweep:
            granite-8b 2 layers, train S=4096, tensor_par and fsdp x
            kernel {plain, cuda}, ``mesh_space=[None, {"data": 1,
            "model": 1}]``, wall clock; then the same sweep as a dry run
            in process and on 2 process workers (each rebuilds the mesh
            in its own world-size-1 group): the same rows and plan byte
            for byte.  The group is destroyed and no process is left.

Every path is driven with the launch counts set to 0 just before it and
read just after.  The last two stdout lines before the final one are the
kernels' JSON line and the ``nvidia-smi`` name/power-limit line; the final
line is ``{"ok": true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--phases build,kernels,...]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "prefill", "serve", "trace",
          "prefill-recurrent", "serve-recurrent", "prefill-moe", "serve-moe",
          "dense", "train", "sweep", "tune", "backends", "mesh")
RECURRENT = ("recurrentgemma-2b", "xlstm-125m")

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, bf16 tensor-core
# rate, and the f32 rate outside the tensor cores (the kernels' f32 inputs
# keep the reference's exact f32 math).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# the mlstm kernel's products are 3xTF32 splits: three TF32 passes each
MLSTM_SPLIT_PASSES = 3

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py floors
# (atol, rtol) of tests/test_kernels.py for the recurrent kernels
RGLRU_TOL = (1e-5, 1e-4)
MLSTM_TOL = (5e-4, 5e-3)
RMSNORM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
# prefill logits, 2 layers at full width, "cuda" vs "plain" plan, bf16
# activations: the two attention paths sum in different orders, so bf16
# roundings of the residual stream may differ by one ulp (2^-8 relative)
PREFILL_ATOL, PREFILL_RTOL = 5e-2, 2e-2
# the recurrent archs tie their head to the N(0, 1) embedding, so logits
# have a standard deviation of ~sqrt(d_model) (~50 at d 2560) and a one-ulp
# change of the bf16 hidden state moves every logit by about that much
# times 2^-8, whatever its own size: the absolute tolerance scales with
# the plain logits' standard deviation (for granite, ~1, it is the same
# 5e-2)
PREFILL_REC_ATOL_PER_STD = 5e-2
# xlstm-125m at full depth (see _compare_plans_xlstm).  The gate: in f32
# the two plans differ only by the mlstm kernel's own error, so the logits
# must agree within 1e-3 of their std (rtol the mlstm kernel's).  In bf16
# the 12-layer stack turns f32 rounding into bf16 flips of the residual
# stream, even between two plain runs, so bf16 is held only on the mean
# gap, to a fixed 0.1 of the logits' std (a gross check).
XLSTM_F32_ATOL_PER_STD = 1e-3
XLSTM_BF16_MEAN_PER_STD = 0.1
# serve-recurrent: the engine on SERVE_REC_N requests of ~SERVE_REC_PROMPT
# prompt tokens and SERVE_REC_NEW new; then the long load: 12 requests on
# 8 slots.  Four short ones (~SERVE_REC_PROMPT prompt tokens,
# SERVE_REC_NEW new) free their slots early; eight long ones
# (~SERVE_LONG_PROMPT prompt tokens, SERVE_LONG_NEW[arch] new) run on, for
# recurrentgemma-2b past its 2048-token window (prompt + new > 2048), so
# its KV ring buffers wrap during batched decode; xlstm-125m has no window,
# and its gates (every request complete, the repeat in a recycled slot)
# hold at any length; the last long one repeats the first one's prompt in
# a recycled slot.
SERVE_REC_N, SERVE_REC_PROMPT, SERVE_REC_NEW = 8, 8, 8
SERVE_LONG_PROMPT = 16
SERVE_LONG_NEW = {"recurrentgemma-2b": 2040, "xlstm-125m": 128}
# granite-8b's serve phase: prompts of SERVE_PROMPT +- 1 tokens (each an
# admission step of B=1 through 36 layers, host-bound), SERVE_NEW new
SERVE_PROMPT, SERVE_NEW = 8, 8
# decode past the window against the full-sequence forward, f32, one
# rec, rec, attn group at full width: f32 on both sides, so the same 1e-3
# of the logits' std as the xlstm gate, and the rglru kernel's rtol
WRAP_F32_ATOL_PER_STD, WRAP_F32_RTOL = 1e-3, 1e-4
# train: granite-8b at full width cut to 8 layers (full depth with f32
# AdamW state is 99 GB, over one card), at train_4k's sequence, B=1;
# TRAIN_STEPS steps, the first of them the warm-up
TRAIN_GRANITE_LAYERS, TRAIN_GRANITE_S, TRAIN_STEPS = 8, 4096, 4
TRAIN_REC_S = 2048                     # recurrentgemma-2b's first group
# xlstm-125m at full width and depth through launch/train.py (its sLSTM
# loop is a host loop over S, so S sets the phase's time)
TRAIN_XLSTM_B, TRAIN_XLSTM_S, TRAIN_XLSTM_STEPS = 8, 256, 2
# per-leaf relative L2 error of the step-0 grads, "cuda" plan against
# "plain" plan, same weights and batch.  In f32 the plans differ by the
# kernels' f32 error only (flash-attention 2e-5): 1e-4.  In bf16 the two
# attention paths round the residual stream differently (the wgmma route
# rounds p to bf16; one bf16 ulp is 2^-8 relative), and the grads follow:
# 0.1.  A dropped gradient reads 1.0.
TRAIN_GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 0.1}
# MoE (qwen3-moe-30b-a3b, kimi-k2-1t-a32b).  Routing: a one-ulp change of
# a hidden state can swap a near-tie of the router's top-k, which changes
# that token's FFN output by O(1), so the "cuda" and "plain" plans are
# compared in two readings: the share of (token, layer) pairs whose
# expert sets agree (held to MOE_AGREE_MIN in bf16), and the logits with
# the plain plan's routing replayed in the cuda plan's run (held
# pointwise: bf16 at the granite 2-layer tolerance; f32 at
# MOE_F32_ATOL_PER_STD of the logits' std, rtol the f32 kernel floor, as
# the xlstm f32 gate).  The f32 comparison runs without replay.
MOE, KIMI = "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"
MOE_S, KIMI_S = 2048, 1024            # prefill-moe sequences, B=1
MOE_AGREE_MIN = 0.9
MOE_F32_ATOL_PER_STD, MOE_F32_RTOL = 1e-3, 2e-5
# serve-moe: 8 requests of 2-4 prompt tokens and 6 new (each decode step
# reads every expert's weights: ~58 GB, >= 17 ms at 3.35 TB/s; each prompt
# token is a B=1 admission step, ~0.3 s on the host)
SERVE_MOE_N, SERVE_MOE_PROMPT, SERVE_MOE_NEW = 8, (2, 4), 6
TRAIN_MOE_LAYERS, TRAIN_MOE_S = 2, 4096
# dense: the remaining dense archs, each served at full depth: prefill at
# B=1, DENSE_S (starcoder2-3b also at DENSE_LONG_S, past its window); the
# engine on DENSE_SERVE_N requests of DENSE_SERVE_PROMPT prompt tokens and
# DENSE_SERVE_NEW new (admission is a host-bound loop of B=1 steps, ~60
# ms a token on an H100, run twice for the batched == sequential gate: at
# 6-10 prompt tokens and 8 new the engines took 43 of the phase's 54 s and
# the whole run 1147 s of its 1200 s limit); DENSE_TRAIN cut to
# DENSE_TRAIN_LAYERS trains from its stub frontend's embeds
DENSE = ("chatglm3-6b", "starcoder2-3b", "phi-3-vision-4.2b",
         "musicgen-large")
DENSE_S, DENSE_LONG_S = 2048, 8192
DENSE_SERVE_N, DENSE_SERVE_PROMPT, DENSE_SERVE_NEW = 8, (3, 5), 6
DENSE_TRAIN, DENSE_TRAIN_LAYERS, DENSE_TRAIN_S = \
    "phi-3-vision-4.2b", 2, 2048
# a stub frontend's embeds (N(0, 1) x 0.02) leave the residual stream to
# the layers' own outputs: the wgmma route's bf16 rounding of p is not
# diluted by a unit-scale token embedding, and the 2-layer bf16 logits of
# the two plans differ past PREFILL_ATOL (on an H100, phi-3-vision-4.2b:
# max 0.056, mean 0.0078; chatglm3-6b from tokens: 0.032, 0.0038).  So an
# embeds prefill is held in f32 pointwise (MOE_F32_ATOL_PER_STD, the FMA
# route), and in bf16 by each plan's distance from the f32 plain run: the
# cuda plan's max and mean within this ratio of the plain plan's own
EMBEDS_BF16_ERR_RATIO = 2.0
# sweep: the allocated memory a sweep may leave behind, and
# recurrentgemma-2b's prefill sweep (B=1, its prefill-recurrent sequence)
SWEEP_MEMORY_SLACK = 64 * 2**20
SWEEP_REC_S = 2048
# tune: the H100 SXM data sheet's rates the calibration is read against;
# a reading above TUNE_MAX_OVER of them is impossible, and one below
# TUNE_LEAST of them (bf16, HBM) would mislead the dry run
TUNE_DATASHEET = {"bfloat16": 989e12, "float32": 67e12, "hbm": 3.35e12}
TUNE_MAX_OVER = 1.05
TUNE_LEAST = {"bfloat16": 0.3, "hbm": 0.5}
# the autotuner's cells: wall-clock repeats, the prefill cells' sequence
# (xlstm-125m's, whose prefill is a host loop over S, at TUNE_XLSTM_S);
# the registry cell: granite-8b's serving shape (capacity 8, cache 2048),
# served 8 requests of ~4 prompt tokens and 4 new
TUNE_REPEATS, TUNE_PREFILL_S, TUNE_XLSTM_S = 3, 2048, 512
TUNE_SERVE_CAPACITY, TUNE_SERVE_CACHE = 8, 2048
TUNE_SERVE_N, TUNE_SERVE_PROMPT, TUNE_SERVE_NEW = 8, 4, 4
# each autotuned op's kernel in LAUNCHES
TUNE_OP_KERNEL = {"flash_attention": "flash_attention",
                  "flash_decode": "flash_decode",
                  "mlstm_chunkwise": "mlstm", "rglru": "rglru"}
# backends: stablelm-3b (H 32, KV 32, D 80) at full width cut to 2 layers
# ((c) at BACKENDS_KILL_LAYERS, so that the killed job is still timing
# when the kill comes), train, B=2 at S=2048 (4096 tokens a step: at B=1 the swept
# microbatches=2 point cannot split the batch and fails, as PlanLint's
# "microbatch" rule says; each microbatch of it is the kernels phase's
# (1, 32, 2048, 80) flash-attention call), the JSON example's providers
# and knob axis with remat {none, dots} x kernel {plain, cuda}
BACKENDS_ARCH, BACKENDS_LAYERS, BACKENDS_B, BACKENDS_S = \
    "stablelm-3b", 2, 2, 2048
BACKENDS_KILL_LAYERS = 8
BACKENDS_SPACE = {"remat": ("none", "dots"), "kernel": ("plain", "cuda")}
BACKENDS_GLOBALS = {"microbatches": (1, 2)}
BACKENDS_REPEATS = 3
# (a): the dry run's depth: rows and plan agree across backends at any
# depth, and fake tensors take ~7 s a program at 8 layers on 2 threads
BACKENDS_DRY_LAYERS = 1
# (c): the killed worker's job is the cuda stack program timed over
# BACKENDS_KILL_REPEATS calls; the parent kills it BACKENDS_KILL_AFTER_S
# after the dispatch, with kernels running on the card
BACKENDS_KILL_REPEATS, BACKENDS_KILL_AFTER_S = 30, 1.5
# (d): the cell's depth for the scoring server (its programs are then not
# b's, timed twice already), and the seeded chaos schedule in front of it
BACKENDS_REMOTE_LAYERS = 1
BACKENDS_CHAOS_SEED, BACKENDS_CHAOS_RATE = 7, 0.2
# (e): the JSON example's depth on the card.  Its spec's block_q 16 splits
# each head's 2048 queries into 128 chunks that the plain path runs one by
# one, host-bound: at its default 8 layers its 8 stack programs take ~121 s
# to time (tools/backends_timing.py --part tile), at 1 layer an eighth
BACKENDS_EXAMPLE_LAYERS = 1
# (e): train_e2e's steps, half of them before the simulated crash (each a
# step of the real xlstm-125m at B=8, S=64, its sLSTM loop host-bound)
BACKENDS_E2E_STEPS = 4
# mesh: the engine's requests (~MESH_PROMPT prompt tokens, MESH_NEW new),
# the train gate's and the sweep's depth and sequence
MESH_PROMPT, MESH_NEW = 3, 4
MESH_TRAIN_LAYERS, MESH_S = 2, 4096
MESH_POINT = {"data": 1, "model": 1}
# mesh (a): qwen3-moe-30b-a3b at full width cut in depth (placing copies
# the weights) for the all-to-all dispatch's prefill at B=1, S=MESH_MOE_S,
# and its step-0 grads in f32 at MESH_MOE_TRAIN_LAYERS
MESH_MOE_LAYERS, MESH_MOE_S, MESH_MOE_TRAIN_LAYERS = 4, 2048, 2
# the a2a dispatch routes in f32 (the reference's), the sorted one in bf16:
# their expert sets part at near-ties more often than two bf16 plans do
# (MOE_AGREE_MIN), so the agreement is a reading held only to this gross
# floor; the pointwise gates are the replayed logits and the f32 grads
MESH_A2A_AGREE_MIN = 0.5
# mesh (b): one granite-8b attention layer at full width, B=8, a cache of
# MESH_DSM_SMAX, MESH_DSM_STEPS positions of decode_shardmap against the
# meshless flash-decode path
MESH_DSM_B, MESH_DSM_SMAX, MESH_DSM_STEPS = 8, 2048, 64
# mesh (c): the dry run's granite-8b decode_32k cells on the fake (16, 16)
# mesh: without decode_shardmap each layer gathers the kv_seq-split caches
# (at least one gather of both: 36 x 2 x 480 MiB = 33.75 GiB a device a
# step); with it no cache is gathered and the collectives stay under
# DRYRUN_DSM_MAX_BYTES (the LSE combine ~8.6 MiB, the tensor-parallel
# all-reduces ~8.6 MiB, q's gather ~2.1 MiB)
DRYRUN_GATHER_MIN_BYTES = 36 * 2 * 480 * 2**20
DRYRUN_DSM_MAX_BYTES = 64 * 2**20
DRYRUN_TIMEOUT_S = 600


class SmokeFailure(Exception):
    pass


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def adopt_orphans():
    """Make this process the child subreaper of its descendants (Linux
    prctl PR_SET_CHILD_SUBREAPER): a process whose parent dies first (a
    scoring server's worker, an example's forkserver) is re-parented here,
    so that :func:`stop_descendants` still finds it."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def descendants() -> list:
    """Pids of every running process below this one (from /proc; an
    exited one waiting to be collected is not running)."""
    children, zombies = {}, set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        children.setdefault(int(ppid), []).append(int(d))
        if state == "Z":
            zombies.add(int(d))
    out, todo = [], [os.getpid()]
    while todo:
        for c in children.get(todo.pop(), ()):
            out.append(c)
            todo.append(c)
    return [p for p in out if p not in zombies]


def _reap():
    """Collect every exited child (adopted ones included)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants(grace_s: float = 15.0) -> list:
    """Stop every process this run started and return the command lines of
    those that were still running.  multiprocessing's forkserver and
    resource tracker outlive the pools that used them until asked to stop;
    anything else left (SIGTERM, then SIGKILL after ``grace_s``) is
    reported."""
    for mod, obj in (("multiprocessing.forkserver", "_forkserver"),
                     ("multiprocessing.resource_tracker",
                      "_resource_tracker")):
        m = sys.modules.get(mod)
        if m is not None:
            try:
                getattr(m, obj)._stop()
            except Exception as e:     # noqa: BLE001 - swept below
                log(f"{mod} stop: {type(e).__name__}: {e}")
    _reap()
    left = []
    for pid in descendants():
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                left.append(f"{pid}: " + f.read().replace(b"\0", b" ")
                            .decode(errors="replace").strip()[:200])
        except OSError:
            pass
    for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 10.0)):
        pids = descendants()
        if not pids:
            break
        for pid in pids:
            try:
                os.kill(pid, sig)
            except OSError:
                pass
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < wait_s:
            _reap()
            if not descendants():
                break
            time.sleep(0.1)
    _reap()
    return left


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def _device_us(a) -> float:
    return getattr(a, "self_device_time_total",
                   getattr(a, "self_cuda_time_total", 0.0))


def device_events(prof):
    """Key averages of the device's own events (kernels, copies, sets),
    whose self time is device time.  A CPU op also carries the time of the
    kernels it launched, so a sum over every event counts those twice."""
    from torch.autograd import DeviceType
    return [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and not getattr(a, "is_user_annotation", False)]


def device_ms(torch, fn, calls: int = 20, warmup: int = 3):
    """Mean device time of one call of ``fn`` in ms (the summed time of
    the device work it launches, from torch.profiler over ``calls``
    calls), and that work per call as {kernel name: {"launches": n,
    "device_ms": t}}.

    The profiler now and then records no device activity at all, or only
    some of the calls' kernels; it is asked three times, and then CUDA
    events around ``calls`` back-to-back calls stand in (logged, and with
    no kernel names)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = device_events(prof)
        total = sum(_device_us(a) for a in evs)
        if total > 0 and all(a.count % calls == 0 for a in evs):
            return total / calls / 1e3, {
                _kernel_name(a.key): {"launches": a.count / calls,
                                      "device_ms": _device_us(a) / calls / 1e3}
                for a in evs}
        log(f"torch.profiler recorded {sum(a.count for a in evs)} device "
            f"events over {calls} calls (attempt {attempt + 1} of 3)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    log("device time from CUDA events around back-to-back calls instead")
    return start.elapsed_time(end) / calls, {}


def _kernel_name(key: str) -> str:
    """A demangled kernel name without namespaces, return type and
    argument list: ``void (anonymous namespace)::f<24>(float ...)`` ->
    ``f<24>``."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ").strip()


def host_ms(torch, fn, calls: int = 200, warmup: int = 10) -> float:
    """Host time of one call of ``fn`` in ms: the wall time of ``calls``
    back-to-back calls, without a synchronize, over ``calls`` (what the
    caller's thread spends before the work is queued)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def max_err(torch, got, want, dtype: str, tol=None):
    """(max |got - want|, ok) under ``tol`` = (atol, rtol), by default
    atol = rtol = TOL[dtype]."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    atol, rtol = tol or (TOL[dtype], TOL[dtype])
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= atol + rtol * w.abs()).all())
    return float(diff.max()), ok


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --- phases ------------------------------------------------------------------

def phase_build(torch, state):
    from repro_torch.kernels import build as K
    t0 = time.perf_counter()
    try:
        res = K.build(verbose=True)
    except RuntimeError as e:        # nvcc's errors are in the message
        raise SmokeFailure(str(e)) from e
    log(f"build: {sorted(res)} in {time.perf_counter() - t0:.1f}s "
        f"(parallel nvcc)")
    for r in res.values():
        log(f"  {r.name}: nvcc {r.seconds:.1f}s")
        fn = ""
        for line in r.log.splitlines():
            m = re.search(r"Function properties for \S*?([a-z_]+_kernel)"
                          r"(\S*)", line)
            if m:     # the kernel and its template arguments, abridged
                args = m.group(2)
                dt = ("bf16 " if "bfloat16" in args else
                      "f32 " if args.startswith("If") else "")
                dims = ",".join(re.findall(r"Li(\d+)E", args))
                fn = m.group(1) + (f"<{dt}{dims}>" if dt or dims else "")
            elif "registers" in line or "spill" in line:
                log(f"  {r.name} {fn}: {line.strip()}")


def _fa_checks(torch, rand, rows, failures, H, KV, D, cases):
    """flash-attention against its plain version at (H, KV, D) for each
    (S, window) of ``cases``, f32 and bf16; kernel, plain and SDPA times."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import (WGMMA_HEAD_DIMS,
                                                     flash_attention_fwd,
                                                     route)
    from repro_torch.kernels.ops import attention_pairs

    dev = torch.device("cuda")
    B = 1
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # model layout (B,S,H,D), passed head-major as views
    for S, window in cases:
        for name, dt in dts.items():
            q = rand((B, S, H, D), dt).transpose(1, 2)
            k = rand((B, S, KV, D), dt).transpose(1, 2)
            v = rand((B, S, KV, D), dt).transpose(1, 2)
            got = flash_attention_fwd(q, k, v, causal=True, window=window)
            want = R.flash_attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err, ok = max_err(torch, got, want, name)
            ms = cuda_ms(torch, lambda: flash_attention_fwd(
                q, k, v, causal=True, window=window))
            plain = cuda_ms(torch, lambda: R.flash_attention_ref(
                q, k, v, causal=True, window=window), reps=5)
            i = torch.arange(S, device=dev)
            live = i[:, None] >= i[None, :]
            if window and window < S:
                live &= i[:, None] - i[None, :] < window
                mask = dict(attn_mask=live)
            else:
                mask = dict(is_causal=True)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, **mask,
                                                      enable_gqa=True)
            lib = cuda_ms(torch, sdpa)
            lib_dev, _ = device_ms(torch, sdpa)
            dev_ms, kernels = device_ms(torch, lambda: flash_attention_fwd(
                q, k, v, causal=True, window=window))
            pairs = attention_pairs(S, S, True, window)
            item = q.element_size()
            nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * item
            flops = 4 * B * H * D * pairs
            bms, by = bound_ms(nbytes, flops, name)
            path = route(dt, D)
            # a bf16 call at a wgmma head dim runs the wgmma kernel, as
            # the profiler names it: no quiet fall back to the FMA route
            if name == "bfloat16" and D in WGMMA_HEAD_DIMS and (
                    path != "wgmma" or not any(
                        f"fa_wgmma_kernel<{D}>" in kn for kn in kernels)):
                ok = False
                log(f"flash_attention bf16 D={D}: route {path}, kernels "
                    f"{sorted(kernels)}: not the wgmma kernel")
            rows.append(dict(kernel="flash_attention", dtype=name, S=S, D=D,
                             H=H, KV=KV, window=window, max_abs_err=err,
                             ok=ok, ms=ms, device_ms=dev_ms,
                             plain_ms=plain, library_ms=lib,
                             library_device_ms=lib_dev, bound_ms=bms,
                             bound_by=by, cuda_route=path,
                             cuda_kernels=sorted(kernels),
                             tflops=flops / ms * 1e-9))
            log(f"flash_attention {name} H={H} KV={KV} D={D} S={S} "
                f"window={window} [{path}]: max_abs_err={err:.3g} "
                f"({'ok' if ok else 'FAIL'}) kernel={ms:.4f}ms "
                f"({flops / ms * 1e-9:.1f} TFLOP/s) device={dev_ms:.4f}ms "
                f"plain={plain:.4f}ms sdpa={lib:.4f}ms "
                f"({flops / lib * 1e-9:.1f} TFLOP/s) device={lib_dev:.4f}ms "
                f"bound={bms:.4f}ms ({by})")
            if not ok:
                failures.append(f"flash_attention {name} D={D} S={S} "
                                f"w={window}")
            del q, k, v, got, want, live


def _fa_bwd_checks(torch, rand, rows, failures, B, S, H, KV, D, window):
    """flash-attention's backward kernel at a train shape, bf16 and causal:
    the forward's log-sum-exp against the plain one's, and dq, dk, dv
    against the op's plain backward (autograd of the q-chunked plain
    attention in f32) on the same inputs; kernel, plain and SDPA backward
    times, and the CUDA kernels of one call."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import (bwd_route,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)

    dt = torch.bfloat16
    # model layout (B,S,H,D), passed head-major as views
    q, g = rand((B, S, H, D), dt), rand((B, S, H, D), dt)
    k, v = rand((B, S, KV, D), dt), rand((B, S, KV, D), dt)
    hm = [t.transpose(1, 2) for t in (q, k, v, g)]
    out, lse = flash_attention_fwd(*hm[:3], causal=True, window=window,
                                   return_lse=True)
    _, lse_want = R.flash_attention_ref(*hm[:3], causal=True, window=window,
                                        return_lse=True)

    def kernel():
        return flash_attention_bwd(hm[3], *hm[:3], out, lse, causal=True,
                                   window=window)

    def plain():
        return ops._vjp(lambda *ts: ops._fa_plain(*ts, True, window, 512),
                        (q, k, v), g)
    got = [t.transpose(1, 2) for t in kernel()]
    want = plain()
    torch.cuda.synchronize()
    lerr, ok = max_err(torch, lse, lse_want, "float32", tol=(1e-3, 1e-4))
    errs, rel = [], []
    for a, b in zip(got, want):
        err, good = max_err(torch, a, b, "bfloat16")
        errs.append(err)
        rel.append(float((a.float() - b.float()).norm() / b.float().norm()))
        ok = ok and good
    del got, want, lse_want
    i = torch.arange(S, device="cuda")
    if window and window < S:
        mask = dict(attn_mask=(i[:, None] >= i[None, :])
                    & (i[:, None] - i[None, :] < window))
    else:
        mask = dict(is_causal=True)
    xs = [t.detach().requires_grad_() for t in hm[:3]]
    sdpa_out = F.scaled_dot_product_attention(*xs, **mask, enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, xs, hm[3], retain_graph=True)
    ms = cuda_ms(torch, kernel)
    dev_ms, kernels = device_ms(torch, kernel)
    plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
    lib = cuda_ms(torch, sdpa_bwd, reps=5)
    lib_dev, _ = device_ms(torch, sdpa_bwd, calls=5)
    del sdpa_out, xs, mask
    pairs = ops.attention_pairs(S, S, True, window)
    flops = 10 * B * H * D * pairs
    # q, k, v, dO read and dq, dk, dv written once; the bound's operations
    # are the forward's two products twice, as fa_bwd_roofline counts them
    nbytes = B * S * D * (3 * H + 4 * KV) * 2
    bms, by = bound_ms(nbytes, 2 * 4 * B * H * D * pairs, "bfloat16")
    path = bwd_route(dt, D)
    per_call = sum(n["launches"] for n in kernels.values()) \
        if kernels else None
    # the wgmma route runs the hand kernel, as the profiler names it
    if path != "wgmma" or not any("fa_bwd_kernel" in kn for kn in kernels):
        ok = False
        log(f"flash_attention_bwd D={D}: route {path}, kernels "
            f"{sorted(kernels)}: not the backward kernel")
    rows.append(dict(kernel="flash_attention_bwd", dtype="bfloat16", B=B,
                     S=S, D=D, H=H, KV=KV, window=window,
                     max_abs_err=max(errs), grad_max_abs_err=errs,
                     grad_rel_l2=rel, lse_max_abs_err=lerr, ok=ok, ms=ms,
                     device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib,
                     library_device_ms=lib_dev, bound_ms=bms, bound_by=by,
                     cuda_route=path, cuda_kernels=sorted(kernels),
                     cuda_kernels_per_call=per_call,
                     tflops=flops / dev_ms * 1e-9))
    log(f"flash_attention_bwd bf16 B={B} H={H} KV={KV} D={D} S={S} "
        f"window={window} [{path}]: grad max_abs_err dq/dk/dv "
        f"{', '.join(f'{e:.3g}' for e in errs)} (rel L2 "
        f"{', '.join(f'{r:.3g}' for r in rel)}), lse {lerr:.3g} "
        f"({'ok' if ok else 'FAIL'}) kernel={ms:.4f}ms device={dev_ms:.4f}ms "
        f"({flops / dev_ms * 1e-9:.1f} TFLOP/s) plain={plain_ms:.4f}ms "
        f"sdpa_bwd={lib:.4f}ms device={lib_dev:.4f}ms bound={bms:.4f}ms "
        f"({by}, {100 * bms / dev_ms:.2f} % of it); CUDA kernels per call "
        f"{kernels}")
    if not ok:
        failures.append(f"flash_attention_bwd D={D} S={S} w={window}")
    if per_call is not None and per_call != 3:
        failures.append(f"flash_attention_bwd D={D} S={S}: {per_call} CUDA "
                        f"kernels per call, not 3")
    del q, k, v, g, hm, out, lse


def _fd_checks(torch, rand, rows, failures, H, KV, D, cases):
    """flash-decode against its plain version at (H, KV, D) for each (B,
    Smax, pos) of ``cases``, f32 and bf16: kernel, plain and SDPA times,
    host time, and the CUDA kernels of one call."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_decode import flash_decode_fwd, plan

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # caches (B,Smax,KV,D), passed head-major as views
    for Bd, Smax, pos in cases:
        for name, dt in dts.items():
            q = rand((Bd, H, D), dt)
            kc = rand((Bd, Smax, KV, D), dt)
            vc = rand((Bd, Smax, KV, D), dt)
            kh, vh = kc.transpose(1, 2), vc.transpose(1, 2)
            got, lse = flash_decode_fwd(q, kh, vh, pos, return_lse=True)
            want, lse_want = R.flash_decode_ref(q, kc, vc, pos,
                                                return_lse=True)
            torch.cuda.synchronize()
            err, ok = max_err(torch, got, want, name)
            lerr, lok = max_err(torch, lse, lse_want, "float32")

            def kern():
                return flash_decode_fwd(q, kh, vh, pos)
            n = pos + 1

            def sdpa():
                return F.scaled_dot_product_attention(
                    q[:, :, None], kh[:, :, :n], vh[:, :, :n],
                    enable_gqa=True)
            ms = cuda_ms(torch, kern, reps=50)
            plain = cuda_ms(torch, lambda: R.flash_decode_ref(q, kc, vc,
                                                              pos), reps=10)
            lib = cuda_ms(torch, sdpa, reps=50)
            dev_ms, kernels = device_ms(torch, kern)
            lib_dev, _ = device_ms(torch, sdpa)
            host = host_ms(torch, kern)
            per_call = sum(k["launches"] for k in kernels.values()) \
                if kernels else None
            item = q.element_size()
            nbytes = (2 * Bd * H * D + 2 * Bd * n * KV * D) * item
            bms, by = bound_ms(nbytes, 4 * Bd * H * D * n, name)
            fd_plan = plan(Bd, H, KV, n, D)
            row = dict(kernel="flash_decode", dtype=name, B=Bd, Smax=Smax,
                       pos=pos, H=H, KV=KV, D=D, max_abs_err=err,
                       lse_max_abs_err=lerr, ok=ok and lok, ms=ms,
                       device_ms=dev_ms, host_ms=host, plain_ms=plain,
                       library_ms=lib, library_device_ms=lib_dev,
                       bound_ms=bms, bound_by=by, plan=fd_plan,
                       cuda_kernels_per_call=per_call)
            rows.append(row)
            log(f"flash_decode {name} B={Bd} H={H} KV={KV} D={D} "
                f"Smax={Smax} pos={pos}: max_abs_err={err:.3g} "
                f"lse_err={lerr:.3g} ({'ok' if ok and lok else 'FAIL'}) "
                f"kernel={ms:.4f}ms device={dev_ms:.4f}ms host={host:.4f}ms "
                f"plain={plain:.4f}ms sdpa={lib:.4f}ms device="
                f"{lib_dev:.4f}ms bound={bms:.4f}ms ({by}); {fd_plan[0]} "
                f"heads a CTA, {fd_plan[1]} slices a kv head, {fd_plan[2]} "
                f"CTAs a slice; CUDA kernels per call {kernels}")
            if not (ok and lok):
                failures.append(f"flash_decode {name} B={Bd} H={H} "
                                f"pos={pos}")
            if per_call is not None and per_call != 1:
                failures.append(f"flash_decode {name} B={Bd} H={H} "
                                f"pos={pos}: {per_call} CUDA kernels per "
                                f"call, not 1")
            del q, kc, vc, kh, vh


def phase_kernels(torch, state):
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_decode import flash_decode_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, KV, D = 32, 8, 128
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    failures = []
    rows = state["kernel_checks"] = []

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dt)

    # granite-8b's heads (S=4096: its train shape); recurrentgemma-2b's
    # (MQA, D=256, its window 2048 at S=2048 and at S=4096 > window);
    # stablelm-3b's (MHA, D=80)
    _fa_checks(torch, rand, rows, failures, H, KV, D,
               ((1000, 0), (2048, 0), (2048, 512), (4096, 0)))
    _fa_checks(torch, rand, rows, failures, 10, 1, 256,
               ((2048, 2048), (4096, 2048)))
    _fa_checks(torch, rand, rows, failures, 32, 32, 80, ((2048, 0),))
    # qwen3-moe-30b-a3b's heads (G=8) and kimi-k2-1t-a32b's (D=112)
    _fa_checks(torch, rand, rows, failures, 32, 4, 128, ((2048, 0),))
    _fa_checks(torch, rand, rows, failures, 64, 8, 112, ((2048, 0),))
    # the dense archs: chatglm3-6b (G=16), starcoder2-3b (G=12, its window
    # 4096 at S=4096 and past it at S=8192), phi-3-vision-4.2b (MHA, D=96)
    # and musicgen-large (MHA, D=64)
    _fa_checks(torch, rand, rows, failures, 32, 2, 128, ((2048, 0),))
    _fa_checks(torch, rand, rows, failures, 24, 2, 128,
               ((4096, 4096), (8192, 4096)))
    _fa_checks(torch, rand, rows, failures, 32, 32, 96, ((2048, 0),))
    _fa_checks(torch, rand, rows, failures, 32, 32, 64, ((2048, 0),))
    # the backward kernel at the two train cells' shapes: granite-8b (B=2,
    # S=4096) and starcoder2-3b (S=8192 past its window 4096)
    _fa_bwd_checks(torch, rand, rows, failures, 2, 4096, H, KV, D, 0)
    _fa_bwd_checks(torch, rand, rows, failures, 1, 8192, 24, 2, 128, 4096)

    # flash decode at granite-8b's heads (admission is B=1, pos ~63; long
    # caches at B=1 and 8; the tune phase's serving shape, B=8 and
    # Smax=2048, at the autotuner's pos 1024 and the registry sweep's
    # segment programs' pos 0) and at recurrentgemma-2b's (G=10, D=256)
    _fd_checks(torch, rand, rows, failures, H, KV, D,
               ((1, 4096, 0), (1, 4096, 17), (1, 4096, 4095),
                (8, 4096, 4095), (1, 2048, 63), (8, 2048, 0),
                (8, 2048, 1024)))
    _fd_checks(torch, rand, rows, failures, 10, 1, 256,
               ((1, 2048, 63), (1, 2048, 2047)))
    # admission of qwen3-moe-30b-a3b (G=8) and kimi-k2-1t-a32b (D=112)
    _fd_checks(torch, rand, rows, failures, 32, 4, 128, ((1, 2048, 63),))
    _fd_checks(torch, rand, rows, failures, 64, 8, 112, ((1, 2048, 63),))
    # admission of the dense archs (chatglm3-6b, starcoder2-3b,
    # phi-3-vision-4.2b, musicgen-large)
    for h, kv, d in ((32, 2, 128), (24, 2, 128), (32, 32, 96),
                     (32, 32, 64)):
        _fd_checks(torch, rand, rows, failures, h, kv, d, ((1, 2048, 63),))

    # the two-shard LSE combine a sequence-sharded decode relies on
    for name, dt in dts.items():
        Smax, pos = 4096, 3000
        q = rand((1, H, D), dt)
        kc = rand((1, Smax, KV, D), dt)
        vc = rand((1, Smax, KV, D), dt)
        half = Smax // 2
        kh, vh = kc.transpose(1, 2), vc.transpose(1, 2)
        o1, l1 = flash_decode_fwd(q, kh[:, :, :half], vh[:, :, :half], pos,
                                  return_lse=True)
        o2, l2 = flash_decode_fwd(q, kh[:, :, half:], vh[:, :, half:],
                                  pos - half, return_lse=True)
        w1 = torch.exp(l1 - torch.logaddexp(l1, l2))[..., None]
        combined = o1.float() * w1 + o2.float() * (1 - w1)
        want = R.flash_decode_ref(q, kc, vc, pos)
        err, ok = max_err(torch, combined, want, name)
        rows.append(dict(kernel="flash_decode_lse_combine", dtype=name,
                         max_abs_err=err, ok=ok))
        log(f"flash_decode two-shard LSE combine {name}: "
            f"max_abs_err={err:.3g} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"lse combine {name}")
    _recurrent_kernel_checks(torch, rand, rows, failures)
    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: "
                           + ", ".join(failures))


def _recurrent_kernel_checks(torch, rand, rows, failures):
    """rglru, mlstm and rmsnorm against their plain versions at the shapes
    of recurrentgemma-2b's and xlstm-125m's prefill (B=1, S=2048)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.build import function
    from repro_torch.kernels.mlstm import mlstm_fwd
    from repro_torch.kernels.rglru import rglru_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    f32 = torch.float32

    def report(kernel, label, err, ok, extra=""):
        log(f"{kernel} {label}: max_abs_err={err:.3g} "
            f"({'ok' if ok else 'FAIL'}){extra}")
        if not ok:
            failures.append(f"{kernel} {label}")

    # rglru: log_a as the model makes it, -8 softplus(1) sigmoid(.), in
    # (-10.6, 0); recurrentgemma's dr = 2560; an odd S, a longer S, and
    # slow decay (log_a ~ -1e-4: the carry crosses every tile undamped;
    # b scaled by sqrt(1 - a^2) as the model does, so that h stays O(1))
    for S, decay in ((2048, "model"), (2047, "model"), (4096, "model"),
                     (4096, "slow")):
        if decay == "slow":
            la = -1e-4 * (1.0 + 0.25 * rand((1, S, 2560), f32).clamp(-2, 2))
            b = rand((1, S, 2560), f32) * torch.sqrt(-torch.expm1(2 * la))
        else:
            la = -8.0 * math.log1p(math.e) * torch.sigmoid(
                rand((1, S, 2560), f32))
            b = rand((1, S, 2560), f32)
        got = rglru_fwd(la, b)
        err, ok = max_err(torch, got, R.rglru_ref(la, b), "float32",
                          RGLRU_TOL)
        row = dict(kernel="rglru", S=S, decay=decay, max_abs_err=err,
                   ok=ok)
        extra = ""
        if S != 2047 and decay == "model":
            n = la.numel()
            bms, by = bound_ms(3 * 4 * n, 3 * n, "float32")
            dev_ms, kernels = device_ms(torch, lambda: rglru_fwd(la, b))
            row.update(ms=cuda_ms(torch, lambda: rglru_fwd(la, b), reps=50),
                       device_ms=dev_ms,
                       plain_ms=cuda_ms(torch, lambda: R.rglru_ref(la, b)),
                       library_ms=None, library_device_ms=None,
                       bound_ms=bms, bound_by=by,
                       cuda_kernels_per_call=kernels)
            extra = (f" kernel={row['ms']:.4f}ms device={dev_ms:.4f}ms "
                     f"plain={row['plain_ms']:.4f}ms library=none "
                     f"bound={bms:.4f}ms ({by}); device work per call "
                     f"{kernels}")
        rows.append(row)
        report("rglru", f"(1, {S}, 2560) f32 {decay} decay", err, ok, extra)
        del la, b, got

    # mlstm at xlstm-125m's heads: H 4, dh 384; q/k/v in the model's
    # permuted layout (einsum outputs), the gates as transposed views
    B, H, S, dh = 1, 4, 2048, 384
    q = rand((B, S, H, dh), f32).transpose(1, 2) * dh ** -0.5
    k = rand((B, S, H, dh), f32).transpose(1, 2)
    v = rand((B, S, H, dh), f32).transpose(1, 2)
    li = rand((B, S, H), f32).transpose(1, 2)
    lf = F.logsigmoid(rand((B, S, H), f32)).transpose(1, 2)
    got = mlstm_fwd(q, k, v, li, lf)
    # the path's clause chunk (256), then the kernel's own and another:
    # the result must not depend on the chunk
    for c in (256, 64, 128):
        err, ok = max_err(torch, got, R.mlstm_chunkwise_ref(
            q, k, v, li, lf, chunk=c), "float32", MLSTM_TOL)
        if c == 256:
            main = dict(kernel="mlstm", S=S, max_abs_err=err, ok=ok)
        rows.append(dict(kernel="mlstm_chunk_check", chunk=c,
                         max_abs_err=err, ok=ok))
        report("mlstm", f"(1, 4, 2048, 384) vs plain chunk {c}", err, ok)
    s0 = 256      # the step-recurrent oracle, over the first 256 steps
    err, ok = max_err(torch, mlstm_fwd(*(t[:, :, :s0] for t in (
        q, k, v, li, lf))), R.mlstm_ref(*(t[:, :, :s0] for t in (
            q, k, v, li, lf))), "float32", MLSTM_TOL)
    rows.append(dict(kernel="mlstm_step_oracle", S=s0, max_abs_err=err,
                     ok=ok))
    report("mlstm", f"(1, 4, {s0}, 384) vs step-recurrent oracle", err, ok)
    c = function("mlstm", "repro_mlstm_chunk", [])()
    main.update(_mlstm_timing(torch, q, k, v, li, lf, c))
    rows.append(main)
    del q, k, v, li, lf, got
    # S=4096 (64 chunks): the parity check, times and one call's peak memory
    S = 4096
    q = rand((B, S, H, dh), f32).transpose(1, 2) * dh ** -0.5
    k = rand((B, S, H, dh), f32).transpose(1, 2)
    v = rand((B, S, H, dh), f32).transpose(1, 2)
    li = rand((B, S, H), f32).transpose(1, 2)
    lf = F.logsigmoid(rand((B, S, H), f32)).transpose(1, 2)
    err, ok = max_err(torch, mlstm_fwd(q, k, v, li, lf),
                      R.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=256),
                      "float32", MLSTM_TOL)
    report("mlstm", f"(1, 4, {S}, 384) vs plain chunk 256", err, ok)
    long_row = dict(kernel="mlstm", S=S, max_abs_err=err, ok=ok)
    long_row.update(_mlstm_timing(torch, q, k, v, li, lf, c))
    rows.append(long_row)
    del q, k, v, li, lf
    # xlstm-125m's train shape (TRAIN_XLSTM_B, TRAIN_XLSTM_S): the parity
    # check and times
    B, S = TRAIN_XLSTM_B, TRAIN_XLSTM_S
    q = rand((B, S, H, dh), f32).transpose(1, 2) * dh ** -0.5
    k = rand((B, S, H, dh), f32).transpose(1, 2)
    v = rand((B, S, H, dh), f32).transpose(1, 2)
    li = rand((B, S, H), f32).transpose(1, 2)
    lf = F.logsigmoid(rand((B, S, H), f32)).transpose(1, 2)
    err, ok = max_err(torch, mlstm_fwd(q, k, v, li, lf),
                      R.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=256),
                      "float32", MLSTM_TOL)
    report("mlstm", f"({B}, 4, {S}, 384) vs plain chunk 256", err, ok)
    train_row = dict(kernel="mlstm", B=B, S=S, max_abs_err=err, ok=ok)
    train_row.update(_mlstm_timing(torch, q, k, v, li, lf, c))
    rows.append(train_row)
    del q, k, v, li, lf

    # rmsnorm at recurrentgemma's norm shape: 2048 rows of d_model 2560
    N, d = 2048, 2560
    for name, dt in (("float32", f32), ("bfloat16", torch.bfloat16)):
        x = rand((N, d), dt)
        scale = rand((d,), dt)
        got = rmsnorm_fwd(x, scale)
        err, ok = max_err(torch, got, R.rmsnorm_ref(x, scale), name,
                          RMSNORM_TOL[name])
        item = x.element_size()
        bms, by = bound_ms(2 * N * d * item + d * item, 4 * N * d,
                           "float32")
        def lib():
            return F.rms_norm(x, (d,), weight=scale, eps=1e-6)

        def kern():
            return rmsnorm_fwd(x, scale)
        row = dict(kernel="rmsnorm", dtype=name, N=N, d=d, max_abs_err=err,
                   ok=ok, ms=cuda_ms(torch, kern, reps=50),
                   device_ms=device_ms(torch, kern)[0],
                   host_ms=host_ms(torch, kern),
                   plain_ms=cuda_ms(torch, lambda: R.rmsnorm_ref(x, scale)),
                   library_ms=cuda_ms(torch, lib, reps=50),
                   library_device_ms=device_ms(torch, lib)[0],
                   library_host_ms=host_ms(torch, lib),
                   bound_ms=bms, bound_by=by)
        rows.append(row)
        report("rmsnorm", f"({N}, {d}) {name}", err, ok,
               f" kernel={row['ms']:.4f}ms device={row['device_ms']:.4f}ms "
               f"host={row['host_ms']:.4f}ms plain={row['plain_ms']:.4f}ms "
               f"rms_norm={row['library_ms']:.4f}ms device="
               f"{row['library_device_ms']:.4f}ms host="
               f"{row['library_host_ms']:.4f}ms bound={bms:.4f}ms ({by})")


def _mlstm_timing(torch, q, k, v, li, lf, c):
    """Times, bounds, CUDA kernels per call and one call's peak memory of
    the mlstm kernels at q's shape (kernel chunk ``c``)."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.mlstm import mlstm_fwd
    from repro_torch.kernels.ops import mlstm_flops

    B, H, S, dh = q.shape
    flops = mlstm_flops(S, dh, c)
    nbytes = 4 * (4 * B * H * S * dh + 2 * B * H * S)
    bms, by = bound_ms(nbytes, MLSTM_SPLIT_PASSES * B * H * flops, "tf32")
    bms_f32, _ = bound_ms(nbytes, B * H * flops, "float32")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = mlstm_fwd(q, k, v, li, lf)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    ms = cuda_ms(torch, lambda: mlstm_fwd(q, k, v, li, lf))
    dev, kernels = device_ms(torch, lambda: mlstm_fwd(q, k, v, li, lf))
    plain = cuda_ms(torch, lambda: R.mlstm_chunkwise_ref(
        q, k, v, li, lf, chunk=256), reps=5)
    log(f"mlstm ({B}, {H}, {S}, {dh}): kernel={ms:.4f}ms device={dev:.4f}ms "
        f"plain={plain:.4f}ms library=none bound={bms:.4f}ms ({by}, "
        f"{MLSTM_SPLIT_PASSES}xTF32 at {PEAK_OPS_S['tf32'] / 1e12:.0f} "
        f"TFLOP/s; {bms_f32:.4f}ms at the f32 rate) kernel chunk {c}; one "
        f"call's peak memory {peak / 2**20:.1f} MiB; CUDA kernels per call "
        f"{kernels}")
    return dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=None,
                library_device_ms=None, bound_ms=bms, bound_by=by,
                bound_ms_f32=bms_f32, chunk=c, peak_bytes=peak,
                cuda_kernels_per_call=kernels)


def _plans(cfg):
    from repro_torch.core.plan import uniform_plan
    from repro_torch.models.context import SegmentClause
    return {k: uniform_plan(cfg, "tensor_par", frozenset({"shard_vocab"}),
                            SegmentClause(kernel=k))
            for k in ("cuda", "plain")}


def _params(torch, cfg, state):
    """``cfg``'s weights from seed 0 on the card, made once per run."""
    cache = state.setdefault("params", {})
    if cfg.name not in cache:
        from repro_torch.models.model import model_specs
        from repro_torch.models.params import init_params, param_count
        t0 = time.perf_counter()
        cache[cfg.name] = init_params(model_specs(cfg),
                                      torch.Generator().manual_seed(0),
                                      "cuda")
        torch.cuda.synchronize()
        log(f"{cfg.name} params: {param_count(model_specs(cfg)) / 1e9:.3f} "
            f"B, init {time.perf_counter() - t0:.1f}s, allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cache[cfg.name]


def phase_prefill(torch, state):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.step import make_prefill

    cfg = get_arch("granite-8b")
    params = _params(torch, cfg, state)
    plans = _plans(cfg)
    gen = torch.Generator().manual_seed(7)
    S = 2048
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen).cuda()
    prefill = make_prefill(cfg, plans["cuda"])
    prefill(params, {"tokens": tokens[:, :128]})       # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    finite = bool(torch.isfinite(logits).all())
    log(f"prefill granite-8b 36 layers B=1 S={S}: {dt * 1e3:.1f} ms "
        f"({S / dt:.0f} tok/s), logits {tuple(logits.shape)} "
        f"{logits.dtype} finite={finite}, launches {launches}")
    state.setdefault("launches", {})["prefill granite-8b"] = launches
    if tuple(logits.shape) != (1, S, cfg.vocab_size) or not finite:
        raise SmokeFailure("full-depth prefill logits not finite/shaped")
    if launches["flash_attention"] != cfg.num_layers:
        raise SmokeFailure(f"prefill launched flash_attention "
                           f"{launches['flash_attention']} times, expected "
                           f"{cfg.num_layers}")
    del logits

    # full width, 2 layers: the "cuda" plan against the "plain" plan
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = dict(params)
    p2["g0"] = {"b0": _slice_layers(params["g0"]["b0"], 2)}
    outs = {k: make_prefill(cfg2, plan)(p2, {"tokens": tokens})
            for k, plan in _plans(cfg2).items()}
    diff = (outs["cuda"] - outs["plain"]).abs()
    ok = bool((diff <= PREFILL_ATOL + PREFILL_RTOL
               * outs["plain"].abs()).all())
    err = float(diff.max())
    log(f"prefill 2 layers cuda vs plain plan: max_abs_err={err:.4g} "
        f"mean_abs_err={float(diff.mean()):.3g} "
        f"(atol {PREFILL_ATOL}, rtol {PREFILL_RTOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("2-layer prefill: cuda plan disagrees with plain")


def _slice_layers(tree, n):
    return {k: _slice_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def phase_serve(torch, state):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import ServeEngine

    cfg = get_arch("granite-8b")
    params = _params(torch, cfg, state)
    eng = ServeEngine(cfg, _plans(cfg)["cuda"], capacity=8, cache_len=2048,
                      params=params)
    reqs = synthetic_requests(8, cfg.vocab_size, prompt_len=SERVE_PROMPT,
                              tokens=SERVE_NEW, seed=0)
    eng.run(reqs[:1])                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    batched = eng.run(reqs)
    launches = dict(LAUNCHES)
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()
    log(f"serve batched: {st.summary()}")
    log(f"serve batched: prefill {st.prefill_tok_s:.1f} tok/s "
        f"({st.n_prefill_tokens} tokens in {st.prefill_s:.2f}s), decode "
        f"{st.decode_tok_s:.1f} tok/s ({st.n_steps} steps in "
        f"{st.decode_s:.2f}s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches {launches}")
    sequential = eng.run(reqs, max_active=1)
    sst = eng.stats
    log(f"serve sequential: {sst.summary()}")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    state.setdefault("launches", {})["serve granite-8b"] = launches
    state["serve granite-8b"] = {"prefill_tok_s": st.prefill_tok_s,
                                 "decode_tok_s": st.decode_tok_s,
                                 "peak_gib": peak / 2**30}
    if st.n_completed != len(reqs) or any(
            len(batched[r.rid].tokens) != r.max_new_tokens for r in reqs):
        raise SmokeFailure("not every request completed")
    diff = [r.rid for r in reqs
            if batched[r.rid].tokens != sequential[r.rid].tokens]
    if diff:
        raise SmokeFailure(f"batched streams differ from sequential: {diff}")
    log(f"serve: {len(reqs)} requests, batched == sequential token for "
        f"token")
    if launches["flash_decode"] != cfg.num_layers * prompt_tokens:
        raise SmokeFailure(f"serve launched flash_decode "
                           f"{launches['flash_decode']} times, expected "
                           f"{cfg.num_layers * prompt_tokens}")


def phase_trace(torch, state):
    """torch.profiler over decode steps of granite-8b's serving path: three
    admission steps (B=1, scalar pos, flash-decode) and three batched steps
    (B=8, per-row pos)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("granite-8b")
    _trace_decode(torch, cfg, _params(torch, cfg, state))


def _trace_decode(torch, cfg, params):
    """Three profiled decode steps at B=1 (scalar pos, as admission) and at
    B=8 (per-row pos, as the batched step) of ``cfg``'s ``"cuda"`` plan.
    Reports wall time per step, device-busy share and the top operations
    by device and by host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import init_cache
    from repro_torch.serve.step import make_decode_step

    step = make_decode_step(cfg, _plans(cfg)["cuda"])
    gen = torch.Generator().manual_seed(11)
    for label, B in (("admission_B1", 1), ("batched_B8", 8)):
        caches = init_cache(cfg, B, 2048)
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen).cuda()

        def pos_of(i):
            return i if B == 1 else torch.full((B,), i, device="cuda")
        for i in range(4):                             # warm-up
            step(params, caches, tok, pos_of(i))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(4, 7):
                step(params, caches, tok, pos_of(i))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
        avgs = prof.key_averages()
        dev = _device_us
        # device work only: a CPU op's self device time repeats its
        # kernels', so a sum over every event counts them twice
        kernels = device_events(prof)
        busy = sum(dev(a) for a in kernels) / 3 / 1e6  # us -> s per step
        both = sum(dev(a) for a in avgs) / 3 / 1e6
        launch_calls = sum(a.count for a in avgs
                           if a.key == "cudaLaunchKernel") / 3
        top_dev = sorted(kernels, key=dev, reverse=True)[:8]
        top_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                         reverse=True)[:8]
        log(f"trace {cfg.name} {label}: {wall * 1e3:.2f} ms/step wall, "
            f"device busy {busy * 1e3:.2f} ms (idle share "
            f"{1 - busy / wall:.3f}; the sum over every event, kernels "
            f"and the ops that launched them, reads {both * 1e3:.2f} ms); "
            f"{launch_calls:.0f} cudaLaunchKernel calls a step")
        for a in top_dev:
            log(f"  device {dev(a) / 3e3:8.3f} ms/step  x{a.count // 3:<5d} "
                f"{a.key[:70]}")
        ours = [a for a in kernels if re.search(PORT_KERNELS, a.key)]
        log("  the port's kernels: " + (", ".join(
            f"{_kernel_name(a.key)} {dev(a) / 3e3:.3f} ms/step "
            f"x{a.count // 3}" for a in ours) or "none"))
        for a in top_cpu:
            log(f"  host   {a.self_cpu_time_total / 3e3:8.3f} ms/step  "
                f"x{a.count // 3:<5d} {a.key[:70]}")
        del caches


def _free_granite(torch, state):
    """Drop granite-8b's 16 GB of weights before the next model loads."""
    if state.get("params", {}).pop("granite-8b", None) is not None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"granite-8b weights freed; allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def _first_group(cfg, params):
    """``cfg`` cut to its first super-block (one rec, rec, attn group for
    recurrentgemma), with layer 0's weights of the stacked group as views."""
    from repro_torch.models.params import layer_slice
    group = cfg.stack_plan()[0]
    cut = dataclasses.replace(cfg, num_layers=len(group.pattern))
    g0 = params["g0"]
    if group.repeats > 1:
        g0 = {b: layer_slice(t, 0) for b, t in g0.items()}
    return cut, {"embed": params["embed"], "g0": g0, "head": params["head"]}


def phase_prefill_recurrent(torch, state):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.step import make_prefill

    _free_granite(torch, state)
    expect = {"recurrentgemma-2b": {"rglru": 18, "flash_attention": 8},
              "xlstm-125m": {"mlstm": 9}}
    S = 2048
    for name in RECURRENT:
        cfg = get_arch(name)
        params = _params(torch, cfg, state)
        gen = torch.Generator().manual_seed(7)
        tokens = torch.randint(0, cfg.vocab_size, (1, S),
                               generator=gen).cuda()
        prefill = make_prefill(cfg, _plans(cfg)["cuda"])
        prefill(params, {"tokens": tokens[:, :128]})    # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        state.setdefault("launches", {})[f"prefill {name}"] = launches
        finite = bool(torch.isfinite(logits).all())
        log(f"prefill {name} {cfg.num_layers} layers B=1 S={S}: "
            f"{dt * 1e3:.1f} ms ({S / dt:.0f} tok/s), logits "
            f"{tuple(logits.shape)} {logits.dtype} finite={finite}, "
            f"launches {launches}")
        if tuple(logits.shape) != (1, S, cfg.vocab_size) or not finite:
            raise SmokeFailure(f"{name}: full-depth prefill logits not "
                               f"finite/shaped")
        want = {k: expect[name].get(k, 0) for k in launches}
        if launches != want:
            raise SmokeFailure(f"{name}: prefill launches {launches}, "
                               f"expected {want}")
        del logits

        # the "cuda" plan against the "plain" plan
        if name == "recurrentgemma-2b":
            _compare_plans(torch, *_first_group(cfg, params), tokens)
        else:
            _compare_plans_xlstm(torch, cfg, params, tokens)


def _compare_plans(torch, cfg, params, inputs):
    """bf16 logits of the "cuda" and "plain" plans, pointwise.  ``inputs``
    is a tokens tensor or a batch ({"tokens"} or {"embeds"}).  A head tied
    to the N(0, 1) embedding is held at PREFILL_REC_ATOL_PER_STD of the
    plain logits' std, any other at PREFILL_ATOL."""
    from repro_torch.serve.step import make_prefill
    batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
    outs = {k: make_prefill(cfg, plan)(params, batch)
            for k, plan in _plans(cfg).items()}
    plain = outs["plain"]
    std = float(plain.std())
    atol = PREFILL_REC_ATOL_PER_STD * std if cfg.tie_embeddings \
        else PREFILL_ATOL
    diff = (outs["cuda"] - plain).abs()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and bool(
        (diff <= atol + PREFILL_RTOL * plain.abs()).all())
    log(f"prefill {cfg.name} {cfg.num_layers} layers cuda vs plain plan: "
        f"max_abs_err={float(diff.max()):.4g} "
        f"mean_abs_err={float(diff.mean()):.3g}, logits std {std:.4g} "
        f"(atol {atol:.4g}, rtol {PREFILL_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{cfg.name}: cuda plan disagrees with plain")


def _compare_plans_xlstm(torch, cfg, params, tokens):
    """xlstm-125m at full depth, "cuda" plan against "plain" plan.

    The gate is pointwise in f32, on the same weights: atol
    XLSTM_F32_ATOL_PER_STD times the logits' std, rtol the mlstm kernel's.
    Two more f32 readings show what it tells apart, and gate nothing: a
    sound pair (the plain plan at chunk 64, the kernel's, against 256, the
    clause's) and a lower-precision control (the plain plan with the
    mLSTM's q, k and v rounded to bf16).  In bf16 only the mean gap is
    held, to XLSTM_BF16_MEAN_PER_STD of the std; the max is printed beside
    that of the sound pair.
    """
    from repro_torch.core.plan import uniform_plan
    from repro_torch.models import xlstm
    from repro_torch.models.context import SegmentClause
    from repro_torch.models.params import tree_map
    from repro_torch.serve.step import make_prefill

    def run(cfg_, params_, kernel, chunk=256):
        plan = uniform_plan(cfg_, "tensor_par", frozenset({"shard_vocab"}),
                            SegmentClause(kernel=kernel, mlstm_chunk=chunk))
        return make_prefill(cfg_, plan)(params_, {"tokens": tokens})

    def gap(got, want):
        return (got - want).abs()

    plain = run(cfg, params, "plain")
    std = float(plain.std())
    d = gap(run(cfg, params, "cuda"), plain)
    sound = gap(run(cfg, params, "plain", 64), plain)
    ok_bf16 = bool(torch.isfinite(d).all()) and float(d.mean()) <= \
        XLSTM_BF16_MEAN_PER_STD * std
    log(f"prefill {cfg.name} {cfg.num_layers} layers bf16 cuda vs plain "
        f"plan: max_abs_err={float(d.max()):.4g} mean_abs_err="
        f"{float(d.mean()):.3g}, logits std {std:.4g} (mean held to "
        f"{XLSTM_BF16_MEAN_PER_STD} std); sound pair plain chunk 64 vs 256: "
        f"max {float(sound.max()):.4g} mean {float(sound.mean()):.3g} "
        f"{'ok' if ok_bf16 else 'FAIL'}")
    del plain, d, sound

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    plain = run(cfg32, p32, "plain")
    std = float(plain.std())
    atol, rtol = XLSTM_F32_ATOL_PER_STD * std, MLSTM_TOL[1]

    def reading(label, got):
        d = gap(got, plain)
        held = bool(torch.isfinite(got).all()) and bool(
            (d <= atol + rtol * plain.abs()).all())
        log(f"prefill {cfg.name} {cfg.num_layers} layers f32 {label}: "
            f"max_abs_err={float(d.max()):.4g} mean_abs_err="
            f"{float(d.mean()):.3g}, within the gate: {held}")
        return held

    log(f"prefill {cfg.name} f32 gate: logits std {std:.4g}, atol "
        f"{atol:.4g} = {XLSTM_F32_ATOL_PER_STD} std, rtol {rtol}")
    ok = reading("cuda vs plain plan (gate)", run(cfg32, p32, "cuda"))
    reading("sound pair, plain chunk 64 vs 256", run(cfg32, p32, "plain", 64))
    exact = xlstm.mlstm_chunkwise_ref

    def rounded(q, k, v, li, lf, *, chunk):
        def r(t):
            return t.bfloat16().float()
        return exact(r(q), r(k), r(v), li, lf, chunk=chunk)

    xlstm.mlstm_chunkwise_ref = rounded
    try:
        reading("control, plain with mLSTM q,k,v in bf16",
                run(cfg32, p32, "plain"))
    finally:
        xlstm.mlstm_chunkwise_ref = exact
    del p32, plain
    if not (ok and ok_bf16):
        raise SmokeFailure(f"{cfg.name}: cuda plan disagrees with plain")


def phase_serve_recurrent(torch, state):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import ServeEngine

    _free_granite(torch, state)
    for name in RECURRENT:
        cfg = get_arch(name)
        params = _params(torch, cfg, state)
        eng = ServeEngine(cfg, _plans(cfg)["cuda"], capacity=8,
                          cache_len=2048, params=params)
        reqs = synthetic_requests(SERVE_REC_N, cfg.vocab_size,
                                  prompt_len=SERVE_REC_PROMPT,
                                  tokens=SERVE_REC_NEW, seed=0)
        eng.run(reqs[:1])                               # warm-up
        torch.cuda.synchronize()
        reset_launches()
        batched = eng.run(reqs)
        launches = dict(LAUNCHES)
        state.setdefault("launches", {})[f"serve {name}"] = launches
        log(f"serve {name} batched: {eng.stats.summary()}, launches "
            f"{launches} (decode is plain, as in the reference)")
        sequential = eng.run(reqs, max_active=1)
        log(f"serve {name} sequential: {eng.stats.summary()}")
        _check_completed(name, reqs, batched)
        diff = [r.rid for r in reqs
                if batched[r.rid].tokens != sequential[r.rid].tokens]
        if diff:
            raise SmokeFailure(f"{name}: batched streams differ from "
                               f"sequential: {diff}")
        log(f"serve {name}: {len(reqs)} requests, batched == sequential "
            f"token for token")
        _serve_long(torch, cfg, params)
        if cfg.window_size:
            _check_window_wrap(torch, cfg, params)
        _trace_decode(torch, cfg, params)
        del eng, params
        state["params"].pop(cfg.name)        # the next arch's peak is its own
        torch.cuda.empty_cache()


def _check_completed(name, reqs, done):
    if len(done) != len(reqs) or any(
            len(done[r.rid].tokens) != r.max_new_tokens for r in reqs):
        raise SmokeFailure(f"{name}: not every request completed")


def _serve_long(torch, full_cfg, full_params):
    """The long load (see SERVE_LONG_NEW) on the arch cut to its first
    pattern of block kinds (one layer of each kind it has): tok/s and peak
    memory, every request complete, and the repeated request's stream
    equal to the first's although it ran in another slot, admitted
    later."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import ServeEngine
    cfg, params = _first_group(full_cfg, full_params)
    eng = ServeEngine(cfg, _plans(cfg)["cuda"], capacity=8, cache_len=2048,
                      params=params)
    long = [dataclasses.replace(r, rid=f"long{i}") for i, r in enumerate(
        synthetic_requests(7, cfg.vocab_size, prompt_len=SERVE_LONG_PROMPT,
                           tokens=SERVE_LONG_NEW[full_cfg.name], seed=1))]
    short = [dataclasses.replace(r, rid=f"short{i}") for i, r in enumerate(
        synthetic_requests(4, cfg.vocab_size, prompt_len=SERVE_REC_PROMPT,
                           tokens=SERVE_REC_NEW, seed=2))]
    again = dataclasses.replace(long[0], rid="long0-again")
    reqs = long[:4] + short + long[4:] + [again]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    st, peak = eng.stats, torch.cuda.max_memory_allocated()
    longest = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    log(f"serve {cfg.name} long load: {st.summary()}")
    log(f"serve {cfg.name} long load, {cfg.num_layers} layers "
        f"{cfg.block_kinds()}: {len(reqs)} requests on "
        f"{eng.capacity} slots, longest sequence {longest} tokens (window "
        f"{cfg.window_size or 'none'}); prefill {st.prefill_tok_s:.1f} tok/s "
        f"({st.n_prefill_tokens} tokens in {st.prefill_s:.2f}s), decode "
        f"{st.decode_tok_s:.1f} tok/s ({st.n_steps} steps in "
        f"{st.decode_s:.2f}s), peak memory {peak / 2**30:.2f} GiB")
    _check_completed(cfg.name, reqs, done)
    first, rep = done["long0"], done["long0-again"]
    if first.slot == rep.slot or first.admitted_step == rep.admitted_step:
        raise SmokeFailure(f"{cfg.name}: the repeated request did not run "
                           f"in a recycled slot")
    if first.tokens != rep.tokens:
        n = next(i for i, (a, b) in enumerate(zip(first.tokens, rep.tokens))
                 if a != b)
        raise SmokeFailure(f"{cfg.name}: the repeated request's stream "
                           f"differs from the first's at token {n}")
    if cfg.window_size and longest <= cfg.window_size:
        raise SmokeFailure(f"{cfg.name}: the long load ({longest} tokens) "
                           f"does not pass the {cfg.window_size}-token "
                           f"window")
    log(f"serve {cfg.name} long load: every request complete; long0 (slot "
        f"{first.slot}, step {first.admitted_step}) == long0-again (slot "
        f"{rep.slot}, step {rep.admitted_step}) token for token")


def _check_window_wrap(torch, cfg, params):
    """Decode past the window against the full-sequence forward, in f32.

    One rec, rec, attn group at full width: the engine's decode step
    (per-row position vector, B=1) consumes window + 64 tokens, so the
    attention's ring buffer wraps, and its logits at positions before and
    after the wrap are held pointwise to the "cuda" plan's forward over
    the same tokens (windowed flash-attention at S > window).
    """
    from repro_torch.models.model import init_cache
    from repro_torch.models.params import tree_map
    from repro_torch.serve.step import make_decode_step, make_prefill
    cut, p = _first_group(cfg, params)
    cut = dataclasses.replace(cut, dtype="float32")
    p = tree_map(lambda t: t.float(), p)
    W = cfg.window_size
    S = W + 64
    tokens = torch.randint(0, cfg.vocab_size, (1, S),
                           generator=torch.Generator().manual_seed(11)).cuda()
    plan = _plans(cut)["cuda"]
    step = make_decode_step(cut, plan)
    caches = init_cache(cut, 1, W, "cuda")
    keep = (W - 1, W, W + 31, S - 1)
    got = []
    t0 = time.perf_counter()
    for i in range(S):
        _, logits, caches = step(p, caches, tokens[:, i],
                                 torch.tensor([i], device="cuda"))
        if i in keep:
            got.append(logits[0].clone())
    dt = time.perf_counter() - t0
    got = torch.stack(got)
    want = make_prefill(cut, plan)(p, {"tokens": tokens})[0, list(keep)]
    std = float(want.std())
    atol = WRAP_F32_ATOL_PER_STD * std
    d = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (d <= atol + WRAP_F32_RTOL * want.abs()).all())
    log(f"serve {cfg.name} window wrap, {cut.num_layers} layers f32: {S} "
        f"decode steps in {dt:.1f}s; logits at positions {keep} vs the "
        f"forward: max_abs_err={float(d.max()):.4g} (per position "
        f"{[round(float(x), 5) for x in d.amax(dim=1)]}), std {std:.4g} "
        f"(atol {atol:.4g} = {WRAP_F32_ATOL_PER_STD} std, rtol "
        f"{WRAP_F32_RTOL}) {'ok' if ok else 'FAIL'}")
    del p, caches, got, want
    if not ok:
        raise SmokeFailure(f"{cfg.name}: decode past the window disagrees "
                           f"with the forward")


# --- MoE -----------------------------------------------------------------------

def _free_params(torch, state):
    """Drop every model's weights before the next model loads."""
    state.get("params", {}).clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"weights freed; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


@contextlib.contextmanager
def _routes(mode=None, store=None):
    """Each MoE layer's routing through ``models.moe.route`` (and the
    all-to-all dispatch's ``route_f32``), in call order: ``"record"`` appends every call's expert ids to ``store``;
    ``"replay"`` makes every call take ``store``'s ids in turn (gates from
    this run's probabilities at those experts, normalized as the router
    does), so that two plans route alike and differ only by their
    kernels."""
    from repro_torch.models import moe
    route, route_f32 = moe.route, moe.route_f32
    replay = iter(store) if mode == "replay" else None

    def wrap(fn):
        def wrapped(router, xf, k):
            probs, gates, idx = fn(router, xf, k)
            if mode == "record":
                store.append(idx.clone())
            elif mode == "replay":
                idx = next(replay).reshape(idx.shape)
                gates = probs.gather(-1, idx)
                gates = gates / gates.sum(dim=-1,
                                          keepdim=True).clamp_min(1e-9)
            return probs, gates, idx
        return wrapped
    moe.route, moe.route_f32 = wrap(route), wrap(route_f32)
    try:
        yield store
    finally:
        moe.route, moe.route_f32 = route, route_f32


def _agreement(torch, a, b):
    """Per layer, the share of tokens whose expert sets agree between two
    recorded routings, and the tokens that agree in every layer."""
    same = torch.stack([(x.sort(-1).values == y.sort(-1).values).all(-1)
                        .reshape(-1) for x, y in zip(a, b)])
    return [round(float(v), 6) for v in same.float().mean(1)], same.all(0)


def _drop_share(torch, cfg, routes):
    """The share of (token, slot) assignments past their expert's capacity
    C, per layer, of a recorded routing (one group: meshless)."""
    from repro_torch.models.moe import capacity
    out = []
    for idx in routes:
        T, k = idx.numel() // idx.shape[-1], idx.shape[-1]
        C = capacity(cfg, T)
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        out.append(float((counts - C).clamp_min(0).sum()) / (T * k))
    return C, out


def _prefill_once(torch, cfg, params, inputs, label, want_fa):
    """``make_prefill`` under the "cuda" plan (after a warm-up) on a tokens
    tensor or a batch ({"tokens"} or {"embeds"}): wall ms, peak memory,
    finite logits of the right shape and exactly ``want_fa``
    flash-attention launches (and no other kernel)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.step import make_prefill
    batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
    prefill = make_prefill(cfg, _plans(cfg)["cuda"])
    prefill(params, {k: t[:, :128] for k, t in batch.items()})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    S = next(iter(batch.values())).shape[1]
    finite = bool(torch.isfinite(logits).all())
    log(f"prefill {label} B=1 S={S}: {dt * 1e3:.1f} ms ({S / dt:.0f} "
        f"tok/s), peak memory {peak / 2**30:.2f} GiB, logits "
        f"{tuple(logits.shape)} {logits.dtype} finite={finite}, launches "
        f"{launches}")
    if tuple(logits.shape) != (1, S, cfg.vocab_size) or not finite:
        raise SmokeFailure(f"{label}: prefill logits not finite/shaped")
    want = {k: want_fa if k == "flash_attention" else 0 for k in launches}
    if launches != want:
        raise SmokeFailure(f"{label}: prefill launches {launches}, "
                           f"expected {want}")
    return launches, prefill


def _profile_prefill(torch, prefill, params, tokens, label):
    """torch.profiler over one prefill call: wall (under the profiler),
    device busy, idle share, ``cudaLaunchKernel`` calls and the top device
    operations, logged; returns the first four."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    busy = sum(_device_us(a) for a in kernels) / 1e3
    calls = sum(a.count for a in prof.key_averages()
                if a.key == "cudaLaunchKernel")
    log(f"trace prefill {label}: {wall:.2f} ms wall under the profiler, "
        f"device busy {busy:.2f} ms (idle share {1 - busy / wall:.3f}); "
        f"{calls} cudaLaunchKernel calls")
    for a in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log(f"  device {_device_us(a) / 1e3:8.3f} ms  x{a.count:<5d} "
            f"{a.key[:70]}")
    # no device events recorded: the idle share is not measured
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if busy > 0 else None,
            "launch_calls": calls}


def _compare_moe_plans(torch, cfg, params, tokens, label):
    """bf16 logits of the "cuda" and "plain" plans (see MOE_AGREE_MIN):
    the expert-set agreement of the two plans' own routings, the logits'
    error at the tokens that agree in every layer (a reading), and the
    logits with the plain plan's routing replayed in the cuda plan's run
    (the pointwise gate)."""
    from repro_torch.serve.step import make_prefill

    def run(kernel, mode, store):
        with _routes(mode, store):
            return make_prefill(cfg, _plans(cfg)[kernel])(
                params, {"tokens": tokens})
    r_plain, r_cuda = [], []
    plain = run("plain", "record", r_plain)
    cuda = run("cuda", "record", r_cuda)
    per_layer, agree = _agreement(torch, r_plain, r_cuda)
    both = agree.reshape(plain.shape[:2])
    d_agree = (cuda - plain).abs()[both]
    forced = run("cuda", "replay", r_plain)
    diff = (forced - plain).abs()
    ok = bool(torch.isfinite(forced).all()) and bool(
        (diff <= PREFILL_ATOL + PREFILL_RTOL * plain.abs()).all())
    share = min(per_layer)
    log(f"prefill {label} bf16 cuda vs plain plan: expert sets agree per "
        f"layer {per_layer} (min {share:.4f}, held >= {MOE_AGREE_MIN}); "
        f"tokens agreeing in every layer {float(agree.float().mean()):.4f}, "
        f"max_abs_err there {float(d_agree.max()) if d_agree.numel() else 0:.4g}; "
        f"with the plain plan's routing replayed: max_abs_err="
        f"{float(diff.max()):.4g} mean_abs_err={float(diff.mean()):.3g} "
        f"(atol {PREFILL_ATOL}, rtol {PREFILL_RTOL}) "
        f"{'ok' if ok and share >= MOE_AGREE_MIN else 'FAIL'}")
    if not ok or share < MOE_AGREE_MIN:
        raise SmokeFailure(f"{label}: cuda plan disagrees with plain")


def _compare_f32(torch, cfg, params, inputs, label):
    """The same in f32 on a cast copy of the weights and of ``inputs`` (a
    tokens tensor or a batch), pointwise without replay (see
    MOE_F32_ATOL_PER_STD); the routing agreement is read beside it.
    Returns the plain plan's f32 logits."""
    from repro_torch.models.params import tree_map
    from repro_torch.serve.step import make_prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
    batch = {k: t.float() if t.is_floating_point() else t
             for k, t in batch.items()}
    routes = {}
    outs = {}
    for k, plan in _plans(cfg32).items():
        with _routes("record", routes.setdefault(k, [])):
            outs[k] = make_prefill(cfg32, plan)(p32, batch)
    plain = outs["plain"]
    std = float(plain.std())
    atol = MOE_F32_ATOL_PER_STD * std
    diff = (outs["cuda"] - plain).abs()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and bool(
        (diff <= atol + MOE_F32_RTOL * plain.abs()).all())
    per_layer = _agreement(torch, routes["plain"], routes["cuda"])[0] \
        if routes["plain"] else "no MoE layer"
    log(f"prefill {label} f32 cuda vs plain plan: max_abs_err="
        f"{float(diff.max()):.4g} mean_abs_err={float(diff.mean()):.3g}, "
        f"logits std {std:.4g} (atol {atol:.4g} = {MOE_F32_ATOL_PER_STD} "
        f"std, rtol {MOE_F32_RTOL}); expert sets agree per layer "
        f"{per_layer} {'ok' if ok else 'FAIL'}")
    del p32, outs
    if not ok:
        raise SmokeFailure(f"{label}: f32 cuda plan disagrees with plain")
    return plain


def _compare_embeds_plans(torch, cfg, params, batch, label):
    """A stub frontend's prefill from ``embeds``, "cuda" against "plain"
    plan, in two readings (see EMBEDS_BF16_ERR_RATIO): in f32 on a cast
    copy, pointwise (``_compare_f32``); in bf16, each plan's distance from
    that f32 plain run, the cuda plan's max and mean within
    EMBEDS_BF16_ERR_RATIO times the plain plan's own."""
    from repro_torch.serve.step import make_prefill
    ref = _compare_f32(torch, cfg, params, batch, label)
    outs = {k: make_prefill(cfg, plan)(params, batch)
            for k, plan in _plans(cfg).items()}
    err = {k: (o - ref).abs() for k, o in outs.items()}
    mx = {k: float(e.max()) for k, e in err.items()}
    mean = {k: float(e.mean()) for k, e in err.items()}
    gap = (outs["cuda"] - outs["plain"]).abs()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and all(
        m["cuda"] <= EMBEDS_BF16_ERR_RATIO * m["plain"] for m in (mx, mean))
    log(f"prefill {label} bf16 against the f32 plain run: cuda plan "
        f"max_abs_err={mx['cuda']:.4g} mean_abs_err={mean['cuda']:.3g}, "
        f"plain plan max_abs_err={mx['plain']:.4g} mean_abs_err="
        f"{mean['plain']:.3g} (ratio bound {EMBEDS_BF16_ERR_RATIO}); cuda "
        f"vs plain max_abs_err={float(gap.max()):.4g} mean_abs_err="
        f"{float(gap.mean()):.3g} {'ok' if ok else 'FAIL'}")
    del ref, outs, err, gap
    if not ok:
        raise SmokeFailure(f"{label}: bf16 cuda plan further from f32 than "
                           f"{EMBEDS_BF16_ERR_RATIO}x the plain plan")


def phase_prefill_moe(torch, state):
    """qwen3-moe-30b-a3b at full width and depth, then kimi-k2-1t-a32b at
    full width cut to its dense layer and one MoE layer."""
    from repro_torch.configs import get_arch

    _free_params(torch, state)
    cfg = get_arch(MOE)
    log(f"{MOE}: allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"before the load (56.9 GiB of bf16 weights to come)")
    params = _params(torch, cfg, state)
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_S),
                           generator=torch.Generator().manual_seed(7)).cuda()
    launches, prefill = _prefill_once(torch, cfg, params, tokens,
                                      f"{MOE} {cfg.num_layers} layers",
                                      cfg.num_layers)
    state.setdefault("launches", {})[f"prefill {MOE}"] = launches
    with _routes("record", []) as routes:
        prefill(params, {"tokens": tokens})
    C, drops = _drop_share(torch, cfg, routes)
    log(f"prefill {MOE}: (token, slot) assignments dropped at capacity "
        f"C={C}: {sum(drops) / len(drops):.5f} of all, per layer "
        f"{[round(x, 5) for x in drops]}")
    _profile_prefill(torch, prefill, params, tokens,
                     f"{MOE} {cfg.num_layers} layers")

    # full width, 2 layers (views): cuda against plain, bf16 and f32
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = dict(params)
    p2["g0"] = {"b0": _slice_layers(params["g0"]["b0"], 2)}
    _compare_moe_plans(torch, cfg2, p2, tokens, f"{MOE} 2 layers")
    _compare_f32(torch, cfg2, p2, tokens, f"{MOE} 2 layers")
    del params, p2
    _free_params(torch, state)

    # kimi-k2: the dense layer and one MoE layer (head_dim 112)
    kimi = dataclasses.replace(get_arch(KIMI), num_layers=2)
    params = _params(torch, kimi, state)
    tokens = torch.randint(0, kimi.vocab_size, (1, KIMI_S),
                           generator=torch.Generator().manual_seed(7)).cuda()
    launches, _ = _prefill_once(torch, kimi, params, tokens,
                                f"{KIMI} 2 layers (attn, attn_moe)", 2)
    state["launches"][f"prefill {KIMI}"] = launches
    _compare_moe_plans(torch, kimi, params, tokens, f"{KIMI} 2 layers")
    # f32 at the dense layer only: the MoE layer in f32 (67.6 GB) does not
    # fit beside the bf16 weights
    dense = dataclasses.replace(kimi, num_layers=1, num_experts=0,
                                experts_per_token=0, first_k_dense=0)
    _compare_f32(torch, dense, {"embed": params["embed"],
                                "g0": params["g0"], "head": params["head"]},
                 tokens, f"{KIMI} dense layer")
    del params
    _free_params(torch, state)


def _seeded_requests(cfg, n, prompt, new):
    """``n`` seeded requests of ``prompt`` = (lo, hi) prompt tokens and
    ``new`` new tokens."""
    import numpy as np

    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(0)
    lo, hi = prompt
    return [Request(rid=f"r{i}", prompt=tuple(int(t) for t in rng.randint(
        0, cfg.vocab_size, int(rng.randint(lo, hi + 1)))),
        max_new_tokens=new) for i in range(n)]


def phase_serve_moe(torch, state):
    """``ServeEngine`` on qwen3-moe-30b-a3b at full depth (capacity 8,
    cache_len 2048, "cuda" plan): every request completes, batched ==
    sequential token for token (8 slots fit the experts' capacity C=8, so
    no token is dropped), flash-decode launches == layers x prompt tokens;
    then the profile of decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.moe import capacity
    from repro_torch.serve.engine import ServeEngine

    _free_params(torch, state)
    cfg = get_arch(MOE)
    params = _params(torch, cfg, state)
    eng = ServeEngine(cfg, _plans(cfg)["cuda"], capacity=8, cache_len=2048,
                      params=params)
    reqs = _seeded_requests(cfg, SERVE_MOE_N, SERVE_MOE_PROMPT,
                            SERVE_MOE_NEW)
    eng.run(reqs[:1])                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    batched = eng.run(reqs)
    launches = dict(LAUNCHES)
    st, peak = eng.stats, torch.cuda.max_memory_allocated()
    state.setdefault("launches", {})[f"serve {MOE}"] = launches
    log(f"serve {MOE} batched: {st.summary()}")
    log(f"serve {MOE} batched: prefill {st.prefill_tok_s:.1f} tok/s "
        f"({st.n_prefill_tokens} tokens in {st.prefill_s:.2f}s), decode "
        f"{st.decode_tok_s:.1f} tok/s ({st.n_steps} steps in "
        f"{st.decode_s:.2f}s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches {launches}; capacity C={capacity(cfg, 8)} for 8 slots")
    sequential = eng.run(reqs, max_active=1)
    log(f"serve {MOE} sequential: {eng.stats.summary()}")
    _check_completed(MOE, reqs, batched)
    diff = [r.rid for r in reqs
            if batched[r.rid].tokens != sequential[r.rid].tokens]
    if diff:
        raise SmokeFailure(f"{MOE}: batched streams differ from "
                           f"sequential: {diff}")
    log(f"serve {MOE}: {len(reqs)} requests, batched == sequential token "
        f"for token")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    if launches["flash_decode"] != cfg.num_layers * prompt_tokens:
        raise SmokeFailure(f"{MOE}: serve launched flash_decode "
                           f"{launches['flash_decode']} times, expected "
                           f"{cfg.num_layers * prompt_tokens}")
    _trace_decode(torch, cfg, params)
    del eng, params
    _free_params(torch, state)


# --- dense -------------------------------------------------------------------

def phase_dense(torch, state):
    """The remaining dense archs at full width and depth, one at a time
    (see the module docstring), then one train step's grads of
    phi-3-vision-4.2b from ``embeds``."""
    from repro_torch.configs import get_arch

    _free_params(torch, state)
    for name in DENSE:
        cfg = get_arch(name)
        params = _params(torch, cfg, state)
        batch = _dense_inputs(cfg, DENSE_S)
        label = f"{name} {cfg.num_layers} layers"
        launches, _ = _prefill_once(torch, cfg, params, batch, label,
                                    cfg.num_layers)
        state.setdefault("launches", {})[f"prefill {name}"] = launches
        if cfg.window_size and cfg.window_size < DENSE_LONG_S:
            # past the window: the kernel's window mask at the arch's shape
            launches, _ = _prefill_once(
                torch, cfg, params, _dense_inputs(cfg, DENSE_LONG_S),
                f"{label} (window {cfg.window_size})", cfg.num_layers)
            state["launches"][f"prefill {name} S{DENSE_LONG_S}"] = launches
        # full width, 2 layers (views): cuda against plain
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        p2 = dict(params)
        p2["g0"] = {"b0": _slice_layers(params["g0"]["b0"], 2)}
        if "embeds" in batch:
            _compare_embeds_plans(torch, cfg2, p2, batch, f"{name} 2 layers")
        else:
            _compare_plans(torch, cfg2, p2, batch)
        del p2, batch
        _serve_dense(torch, cfg, params, state)
        del params
        _free_params(torch, state)
    _train_dense(torch, state)


def _dense_inputs(cfg, seq):
    """The prefill's input at B=1 as the pipeline draws it (seed 0): tokens,
    or ``embeds`` for a stub frontend."""
    batch = _train_data(cfg, seq).batch_at(0)
    return {k: t for k, t in batch.items() if k in ("tokens", "embeds")}


def _serve_dense(torch, cfg, params, state):
    """``ServeEngine`` (capacity 8, cache 2048, "cuda" plan) on
    DENSE_SERVE_N token prompts: every request completes, batched ==
    sequential, flash-decode launches == layers x prompt tokens (0 when the
    arch has a window: windowed decode is plain, as the reference's)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, _plans(cfg)["cuda"], capacity=8, cache_len=2048,
                      params=params)
    reqs = _seeded_requests(cfg, DENSE_SERVE_N, DENSE_SERVE_PROMPT,
                            DENSE_SERVE_NEW)
    eng.run(reqs[:1])                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    batched = eng.run(reqs)
    launches = dict(LAUNCHES)
    st, peak = eng.stats, torch.cuda.max_memory_allocated()
    state.setdefault("launches", {})[f"serve {cfg.name}"] = launches
    log(f"serve {cfg.name} batched: prefill {st.prefill_tok_s:.1f} tok/s "
        f"({st.n_prefill_tokens} tokens in {st.prefill_s:.2f}s), decode "
        f"{st.decode_tok_s:.1f} tok/s ({st.n_steps} steps in "
        f"{st.decode_s:.2f}s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches {launches}")
    sequential = eng.run(reqs, max_active=1)
    log(f"serve {cfg.name} sequential: {eng.stats.summary()}")
    _check_completed(cfg.name, reqs, batched)
    diff = [r.rid for r in reqs
            if batched[r.rid].tokens != sequential[r.rid].tokens]
    if diff:
        raise SmokeFailure(f"{cfg.name}: batched streams differ from "
                           f"sequential: {diff}")
    want = 0 if cfg.window_size else \
        cfg.num_layers * sum(len(r.prompt) for r in reqs)
    log(f"serve {cfg.name}: {len(reqs)} requests, batched == sequential "
        f"token for token; flash_decode {launches['flash_decode']} "
        f"launches (expected {want})")
    if launches["flash_decode"] != want:
        raise SmokeFailure(f"{cfg.name}: serve launched flash_decode "
                           f"{launches['flash_decode']} times, expected "
                           f"{want}")


def _train_dense(torch, state):
    """DENSE_TRAIN at full width cut to DENSE_TRAIN_LAYERS layers, B=1,
    S=DENSE_TRAIN_S, bf16, remat "dots", from its pipeline's ``embeds``:
    step-0 grads of the "cuda" plan against the "plain" plan, and the cuda
    plan's flash-attention launches (a forward and a recompute a layer, and
    a backward kernel a layer where ``bwd_route`` takes the arch)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import bwd_route
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, tree_map

    cfg = dataclasses.replace(get_arch(DENSE_TRAIN),
                              num_layers=DENSE_TRAIN_LAYERS)
    plans = _train_plans(cfg, "dots")
    params = tree_map(lambda t: t.requires_grad_(), init_params(
        model_specs(cfg), torch.Generator().manual_seed(0), "cuda"))
    batch = _train_data(cfg, DENSE_TRAIN_S).batch_at(0)
    if "embeds" not in batch or "tokens" in batch:
        raise SmokeFailure(f"{cfg.name}: the pipeline's batch holds "
                           f"{sorted(batch)}, not embeds")
    reset_launches()
    _grads_gate(torch, f"{cfg.name} {cfg.num_layers} layers bf16 embeds",
                cfg, plans, params, batch, TRAIN_GRAD_REL_L2["bfloat16"])
    launches = dict(LAUNCHES)
    state.setdefault("launches", {})[f"train {cfg.name}"] = launches
    want = {"flash_attention": 2 * cfg.num_layers}
    if bwd_route(getattr(torch, cfg.dtype), cfg.head_dim_) == "wgmma":
        want["flash_attention_bwd"] = cfg.num_layers
    log(f"train {cfg.name} {cfg.num_layers} layers: launches {launches} "
        f"(the cuda plan's grads; the plain plan's launch none)")
    if {k: n for k, n in launches.items() if n} != want:
        raise SmokeFailure(f"train {cfg.name}: launches {launches}, "
                           f"expected {want}")
    del params
    torch.cuda.empty_cache()


# --- train ---------------------------------------------------------------------

def _train_plans(cfg, remat):
    """"cuda" and "plain" train plans: the reference's train default
    (hybrid2d[shard_vocab], f32 optimizer state) with ``remat`` and each
    kernel choice."""
    from repro_torch.core.combinator import GlobalKnobs
    from repro_torch.core.plan import uniform_plan
    from repro_torch.models.context import SegmentClause
    return {k: uniform_plan(cfg, "hybrid2d", frozenset({"shard_vocab"}),
                            SegmentClause(remat=remat, kernel=k),
                            GlobalKnobs(opt_state_dtype="float32"))
            for k in ("cuda", "plain")}


def _train_data(cfg, seq, batch=1):
    """``SyntheticLM`` at (batch, seq), seed 0, on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg, ShapeConfig(f"train-{batch}x{seq}", seq, batch,
                                        "train"), seed=0, device="cuda")
    return data


def _grads_gate(torch, label, cfg, plans, params, batch, bound):
    """Step-0 grads of the "cuda" plan against the "plain" plan on the same
    weights and batch: per leaf, the relative L2 error (a dropped gradient
    reads 1.0) under ``bound``, and every leaf's grad norm > 0, but for the
    embedding table under an ``embeds`` batch (an untied head does not
    read it), whose grad is zero in both plans.  For an MoE arch the cuda
    plan's run replays the plain plan's routing (see MOE_AGREE_MIN)."""
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import tree_leaves, tree_map_with_path
    from repro_torch.train.step import make_grads

    out, routes = {}, []
    for k in ("plain", "cuda"):
        mode = ("record" if k == "plain" else "replay") if cfg.is_moe \
            else None
        t0 = time.perf_counter()
        with _routes(mode, routes):
            loss, _, grads = make_grads(cfg, plans[k], device="cuda")(
                params, batch)
        torch.cuda.synchronize()
        out[k] = (float(loss), grads, time.perf_counter() - t0)
    paths = tree_leaves(tree_map_with_path(lambda p, _: "/".join(p),
                                           model_specs(cfg)))
    unread = "embed/tok" if "embeds" in batch and not cfg.tie_embeddings \
        else None
    worst, bad, rows = 0.0, [], []
    for path, g, w in zip(paths, tree_leaves(out["cuda"][1]),
                          tree_leaves(out["plain"][1])):
        norm = float(g.float().norm())
        if path == unread:
            rows.append(f"{path} unread")
            if norm or float(w.float().norm()):
                bad.append(f"{path} (unread, norm {norm:.3g})")
            continue
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        rows.append(f"{path} {rel:.3g}")
        worst = max(worst, rel)
        if not (norm > 0 and rel < bound):
            bad.append(f"{path} (norm {norm:.3g}, rel {rel:.3g})")
    log(f"train {label} step-0 grads, cuda vs plain plan: loss "
        f"{out['cuda'][0]:.6g} vs {out['plain'][0]:.6g}; grads "
        f"{out['cuda'][2] * 1e3:.0f} vs {out['plain'][2] * 1e3:.0f} ms; "
        f"relative L2 error per leaf (bound {bound}): {', '.join(rows)}; "
        f"worst {worst:.3g} {'ok' if not bad else 'FAIL'}")
    del out
    torch.cuda.empty_cache()
    if bad:
        raise SmokeFailure(f"train {label}: cuda-plan grads disagree with "
                           f"plain or are zero: {bad}")


def phase_train(torch, state):
    """The training path (see the module docstring): granite-8b at full
    width, 8 layers; recurrentgemma-2b's first group; xlstm-125m through
    ``launch/train.py`` with a checkpoint restart."""
    state.get("params", {}).clear()       # the served models' weights
    torch.cuda.empty_cache()
    _train_granite(torch, state)
    _train_recurrentgemma(torch, state)
    _train_moe(torch, state)
    _train_xlstm(torch, state)


def _train_granite(torch, state):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.step import (init_train_state, make_grads,
                                        make_train_step)

    full = get_arch("granite-8b")
    S = TRAIN_GRANITE_S
    # one f32 layer at full width (the FMA route): the f32 gate
    cfg32 = dataclasses.replace(full, num_layers=1, dtype="float32")
    plans = _train_plans(cfg32, "dots")
    p32, _ = init_train_state(cfg32, plans["plain"],
                              torch.Generator().manual_seed(0), "cuda")
    data = _train_data(cfg32, S)
    _grads_gate(torch, "granite-8b 1 layer f32", cfg32, plans, p32,
                data.batch_at(0), TRAIN_GRAD_REL_L2["float32"])
    del p32
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, num_layers=TRAIN_GRANITE_LAYERS)
    plans = _train_plans(cfg, "dots")
    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, plans["cuda"],
                                   torch.Generator().manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"train granite-8b {cfg.num_layers} layers: init_train_state "
        f"{time.perf_counter() - t0:.1f}s, allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (params and f32 "
        f"AdamW state)")
    data = _train_data(cfg, S)
    _grads_gate(torch, f"granite-8b {cfg.num_layers} layers bf16", cfg,
                plans, params, data.batch_at(0),
                TRAIN_GRAD_REL_L2["bfloat16"])

    step = make_train_step(cfg, plans["cuda"], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data.batch_at(s))
        losses.append(float(m["total_loss"]))      # waits for the step
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state.setdefault("launches", {})["train granite-8b"] = launches
    steady = statistics.median(times[1:])
    fa_per_step = launches["flash_attention"] / TRAIN_STEPS
    log(f"train granite-8b {cfg.num_layers} layers B=1 S={S}, cuda plan "
        f"remat=dots: losses {[round(x, 5) for x in losses]}; step ms "
        f"{[round(t * 1e3, 1) for t in times]} (steady {steady * 1e3:.1f} "
        f"ms, {S / steady:.0f} tok/s); peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches} ({fa_per_step:g} flash-attention a step)")
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"train granite-8b: losses {losses}")
    if fa_per_step != 2 * cfg.num_layers:
        raise SmokeFailure(f"train granite-8b: {fa_per_step} flash-attention "
                           f"launches a step, expected {2 * cfg.num_layers} "
                           f"(a forward and a recompute per layer)")

    # where the step goes: one layer's flash-attention forward and backward
    # (the backward kernel, or the plain f32 attention's autograd where
    # ``bwd_route`` says so), the head's
    # product with its backward (f32 copies under grad), and one AdamW
    # update with the peak of its temporaries (CUDA events; launches here
    # are not the path's)
    from repro_torch.models.model import _matmul_f32
    H, KV, D = full.num_heads, full.num_kv_heads, full.head_dim_
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dt)
    q, k, v = (rand((1, S, h, D)).requires_grad_() for h in (H, KV, KV))
    g = rand((1, S, H, D))
    with torch.no_grad():
        fwd = cuda_ms(torch, lambda: ops.flash_attention(q, k, v), reps=5)
    both = cuda_ms(torch, lambda: torch.autograd.grad(
        ops.flash_attention(q, k, v), (q, k, v), g), reps=3, warmup=1)
    x = rand((1, S, full.d_model)).requires_grad_()
    gl = rand((1, S, full.vocab_size), torch.float32)
    w = params["head"]["out"]
    head = cuda_ms(torch, lambda: torch.autograd.grad(
        _matmul_f32(x, w), (x, w), gl), reps=3, warmup=1)
    del q, k, v, g, x, gl
    _, _, grads = make_grads(cfg, plans["cuda"], device="cuda")(
        params, data.batch_at(TRAIN_STEPS))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    adam = cuda_ms(torch, lambda: adamw_update(grads, opt, params, lr=1e-6),
                   reps=3, warmup=1)
    adam_peak = torch.cuda.max_memory_allocated() - base
    bwd = both - fwd
    step_ms = steady * 1e3
    log(f"train granite-8b step breakdown (CUDA events): flash-attention "
        f"forward {fwd:.3f} ms and backward {bwd:.3f} ms a layer at (1, {S}, "
        f"{H}/{KV}, {D}): {cfg.num_layers} backward {cfg.num_layers * bwd:.1f} "
        f"ms = {cfg.num_layers * bwd / step_ms:.3f} of the step; the head's "
        f"product and its backward {head:.1f} ms = {head / step_ms:.3f}; one "
        f"AdamW update {adam:.1f} ms = {adam / step_ms:.3f}, its "
        f"temporaries' peak {adam_peak / 2**20:.0f} MiB")
    del params, opt, grads
    torch.cuda.empty_cache()


def _train_recurrentgemma(torch, state):
    """recurrentgemma-2b cut to its first group (rec, rec, attn) at full
    width, B=1, S=2048, no remat: step-0 grads of the "cuda" plan against
    the "plain" plan, then two steps of the "cuda" plan."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train.step import init_train_state, make_train_step

    full = get_arch("recurrentgemma-2b")
    cfg = dataclasses.replace(full, num_layers=len(full.block_pattern))
    plans = _train_plans(cfg, "none")
    params, opt = init_train_state(cfg, plans["cuda"],
                                   torch.Generator().manual_seed(0), "cuda")
    data = _train_data(cfg, TRAIN_REC_S)
    _grads_gate(torch, f"recurrentgemma-2b {cfg.num_layers} layers bf16",
                cfg, plans, params, data.batch_at(0),
                TRAIN_GRAD_REL_L2["bfloat16"])
    step = make_train_step(cfg, plans["cuda"], device="cuda")
    reset_launches()
    losses, times = [], []
    for s in range(2):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data.batch_at(s))
        losses.append(float(m["total_loss"]))
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    state.setdefault("launches", {})["train recurrentgemma-2b"] = launches
    want = {"rglru": 2 * 2, "flash_attention": 2 * 1}
    log(f"train recurrentgemma-2b {cfg.num_layers} layers B=1 "
        f"S={TRAIN_REC_S}, cuda plan remat=none: losses {losses}, step ms "
        f"{[round(t * 1e3, 1) for t in times]}, launches {launches}")
    if {k: n for k, n in launches.items() if n} != want or \
            not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"train recurrentgemma-2b: launches {launches} "
                           f"(expected {want}), losses {losses}")
    del params, opt
    torch.cuda.empty_cache()


def _train_moe(torch, state):
    """qwen3-moe-30b-a3b at full width cut to TRAIN_MOE_LAYERS layers, B=1,
    S=TRAIN_MOE_S, remat "dots": the step-0 grads gate in f32 (the FMA
    route) and in bf16 (f32 AdamW state), then two steps of the "cuda"
    plan: loss and aux loss, step ms, peak memory, flash-attention launches
    a step (a forward and a recompute per layer)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train.step import init_train_state, make_train_step

    full = get_arch(MOE)
    n, S = TRAIN_MOE_LAYERS, TRAIN_MOE_S
    cfg32 = dataclasses.replace(full, num_layers=n, dtype="float32")
    plans = _train_plans(cfg32, "dots")
    p32, _ = init_train_state(cfg32, plans["plain"],
                              torch.Generator().manual_seed(0), "cuda")
    _grads_gate(torch, f"{MOE} {n} layers f32", cfg32, plans, p32,
                _train_data(cfg32, S).batch_at(0),
                TRAIN_GRAD_REL_L2["float32"])
    del p32
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, num_layers=n)
    plans = _train_plans(cfg, "dots")
    params, opt = init_train_state(cfg, plans["cuda"],
                                   torch.Generator().manual_seed(0), "cuda")
    data = _train_data(cfg, S)
    _grads_gate(torch, f"{MOE} {n} layers bf16", cfg, plans, params,
                data.batch_at(0), TRAIN_GRAD_REL_L2["bfloat16"])
    step = make_train_step(cfg, plans["cuda"], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, aux, times = [], [], []
    for i in range(2):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data.batch_at(i))
        losses.append(float(m["total_loss"]))
        aux.append(float(m["aux_loss"]))
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state.setdefault("launches", {})[f"train {MOE}"] = launches
    fa_per_step = launches["flash_attention"] / 2
    log(f"train {MOE} {n} layers B=1 S={S}, cuda plan remat=dots: losses "
        f"{[round(x, 5) for x in losses]} (aux loss "
        f"{[round(x, 5) for x in aux]}); step ms "
        f"{[round(t * 1e3, 1) for t in times]} ({S / times[-1]:.0f} tok/s "
        f"at the second); peak memory {peak / 2**30:.2f} GiB; launches "
        f"{launches} ({fa_per_step:g} flash-attention a step)")
    if not all(math.isfinite(x) for x in losses + aux) or \
            fa_per_step != 2 * n:
        raise SmokeFailure(f"train {MOE}: losses {losses}, aux {aux}, "
                           f"{fa_per_step} flash-attention launches a step "
                           f"(expected {2 * n})")
    del params, opt
    torch.cuda.empty_cache()


def _train_xlstm(torch, state):
    """xlstm-125m at full width and depth through ``launch/train.py`` with
    a "cuda" plan file: TRAIN_XLSTM_STEPS straight, then half of them, a
    restart from the latest checkpoint and the rest.  The resumed losses
    must equal the uninterrupted run's bit for bit: the data is a function
    of the step, the checkpoint carries the state exactly, and every op of
    the step runs in a fixed order (no atomics)."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train

    cfg = get_arch("xlstm-125m")
    n, half = TRAIN_XLSTM_STEPS, TRAIN_XLSTM_STEPS // 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        plan = Path(tmp) / "plan.json"
        _train_plans(cfg, "dots")["cuda"].save(str(plan))
        common = ["--arch", cfg.name, "--plan", str(plan), "--batch",
                  str(TRAIN_XLSTM_B), "--seq", str(TRAIN_XLSTM_S),
                  "--device", "cuda", "--log-every", "1", "--ckpt-every",
                  str(n)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        straight = train(common + ["--steps", str(n), "--resume", "never",
                                   "--ckpt-dir", str(Path(tmp) / "a")])
        dt = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        state.setdefault("launches", {})["train xlstm-125m"] = launches
        first = train(common + ["--steps", str(half), "--ckpt-dir",
                                str(Path(tmp) / "b")])
        rest = train(common + ["--steps", str(n), "--ckpt-dir",
                               str(Path(tmp) / "b")])
    tokens = TRAIN_XLSTM_B * TRAIN_XLSTM_S
    per_step = launches["mlstm"] / n
    log(f"train xlstm-125m {cfg.num_layers} layers B={TRAIN_XLSTM_B} "
        f"S={TRAIN_XLSTM_S} through launch/train.py, cuda plan remat=dots: "
        f"{n} steps in {dt:.1f}s ({n * tokens / dt:.0f} tok/s with the "
        f"first step and the checkpoint write), peak memory "
        f"{peak / 2**30:.2f} GiB, launches {launches} ({per_step:g} mlstm a "
        f"step); losses {straight}; resumed at step {half}: {rest}")
    if per_step != 2 * 9:
        raise SmokeFailure(f"train xlstm-125m: {per_step} mlstm launches a "
                           f"step, expected 18 (9 layers, forward and "
                           f"recompute)")
    if first != straight[:half] or rest != straight[half:]:
        gap = max(abs(a - b) for a, b in zip(first + rest, straight))
        raise SmokeFailure(f"train xlstm-125m: the resumed run's losses "
                           f"differ from the uninterrupted run's (max gap "
                           f"{gap:.3g})")
    log(f"train xlstm-125m: the restart from step {half} replays the "
        f"uninterrupted run's losses bit for bit")


# --- sweep ---------------------------------------------------------------------

def phase_sweep(torch, state):
    """The ComPar sweep on the card (see the module docstring): A, the
    quickstart's path; B, recurrentgemma-2b's prefill; C, the dry run."""
    state.get("params", {}).clear()
    torch.cuda.empty_cache()
    # cuBLAS keeps a workspace per handle in the caching allocator from
    # its first product on: take it before gate (d) reads the baseline
    for dt in (torch.bfloat16, torch.float32):
        x = torch.ones(64, 64, device="cuda", dtype=dt, requires_grad=True)
        torch.autograd.grad((x @ x).sum(), x)
    del x
    torch.cuda.synchronize()
    a = state["sweep A"] = _sweep_quickstart(torch, state)
    _sweep_recurrentgemma(torch, state)
    state["sweep C"] = _sweep_dry_run(torch, state, a)


def _programs(tuner, knobs=False):
    """One row per unique program (segment, clause; with ``knobs`` also
    the microbatches point) of a sweep: its status, median ms, peak GiB
    and error."""
    out = {}
    for r in tuner.db.results(tuner.project):
        cl = r["combo"].clause
        key = f"{r['segment']}/{cl.remat}/{cl.kernel}"
        if knobs:
            key += f"/mb{r['knobs'].microbatches if r['knobs'] else 1}"
        if key in out:
            continue
        d = (r["cost"] or {}).get("detail", {})
        out[key] = {"status": r["status"], "error": r["error"],
                    "median_ms": d["wall_s"] * 1e3 if "wall_s" in d else None,
                    "peak_gib": d["peak_bytes"] / 2**30
                    if "peak_bytes" in d else None,
                    "total_s": (r["cost"] or {}).get("total_s")}
    return out


@contextlib.contextmanager
def _launches_per_job(knobs=False):
    """Each wall-clock job's kernel launches (its warm-up and timed calls),
    keyed ``segment/remat/kernel`` (``/mb<n>`` added with ``knobs``):
    every job of a sweep run inside."""
    from repro_torch.core.executor import WallClockExecutor
    from repro_torch.kernels import LAUNCHES

    per_job = {}
    score = WallClockExecutor.score_segment

    def counted(self, cfg, shape, seg, combo, *a, **kw):
        n0 = dict(LAUNCHES)
        try:
            return score(self, cfg, shape, seg, combo, *a, **kw)
        finally:
            cl = combo.clause
            key = f"{seg.name}/{cl.remat}/{cl.kernel}"
            if knobs:
                key += f"/mb{getattr(kw.get('knobs'), 'microbatches', 1)}"
            per_job[key] = {k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
    WallClockExecutor.score_segment = counted
    try:
        yield per_job
    finally:
        WallClockExecutor.score_segment = score


def _job_launch_gates(cfg, tuner, space, per_job):
    """Each stack group was scored under every (remat, kernel) of
    ``space``, and each job's launches match its clause: every kernel 0
    under ``plain``; under ``cuda``, each attention and recurrent layer
    launches flash-attention and rglru once per call (twice under remat,
    whose backward reruns the forward), each attention layer the
    flash-attention backward kernel once per call where its route takes
    the arch (``bwd_route``), and nothing else."""
    import torch

    from repro_torch.kernels.flash_attention import bwd_route
    calls = 1 + tuner.executor.repeats         # the warm-up and the timed
    groups = cfg.stack_plan()
    bwd = bwd_route(getattr(torch, cfg.dtype), cfg.head_dim_) == "wgmma"
    fail = [f"g{g}/{r}/{k}: no job scored" for g in range(len(groups))
            for r in space["remat"] for k in space["kernel"]
            if f"g{g}/{r}/{k}" not in per_job]
    for key, got in per_job.items():
        seg, remat, kernel = key.split("/")
        want = dict.fromkeys(got, 0)
        if kernel == "cuda" and seg.startswith("g"):
            group = groups[int(seg[1:])]
            per_call = (2 if remat in ("dots", "full") else 1) * group.repeats
            want["flash_attention"] = group.pattern.count("attn") * \
                per_call * calls
            want["rglru"] = group.pattern.count("rec") * per_call * calls
            if bwd:
                want["flash_attention_bwd"] = group.pattern.count("attn") * \
                    group.repeats * calls
        if got != want:
            fail.append(f"{key}: launches {got}, expected {want}")
    return fail


def _sweep_quickstart(torch, state):
    import tempfile

    from repro_torch.core.fusion import fuse
    from repro_torch.core.cost_model import CostTerms
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.examples import quickstart
    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp, \
            _launches_per_job() as per_job:
        reset_launches()
        t0 = time.perf_counter()
        out = quickstart.main(["--device", "cuda", "--layers",
                               str(TRAIN_GRANITE_LAYERS), "--steps", "3",
                               "--plan-out", str(Path(tmp) / "plan.json")])
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    state.setdefault("launches", {})["sweep granite-8b"] = launches
    tuner, plan, rep = out["tuner"], out["plan"], out["report"]
    cfg, shape = out["cfg"], out["shape"]
    rows = tuner.db.results(tuner.project)
    programs = _programs(tuner)
    failures = {k: p["error"] for k, p in programs.items()
                if p["status"] != "done"}
    # every job scored, and each ran the kernels its clause names: a cuda
    # job that failed on the card must not leave the plan to plain rows
    fail = _job_launch_gates(cfg, tuner, out["space"], per_job)
    if rep.n_failed or failures:
        fail.append(f"{rep.n_failed} failed rows: {failures}")
    # (a) every registered row settled
    pending = tuner.db.pending(tuner.project)
    if pending:
        fail.append(f"{len(pending)} rows left pending")
    # (b) the plan is fuse() of the DB's rows; its total the chosen rows'
    results = {}
    for r in rows:
        if r["status"] == "done":
            results.setdefault(r["segment"], []).append(
                (r["combo"], CostTerms.from_dict(r["cost"])))
    fused = fuse(cfg, shape, None, results, plan.knobs)
    if fused.segments != plan.segments:
        fail.append(f"plan {plan.describe()} != fuse of the DB's rows "
                    f"{fused.describe()}")
    chosen = sum(min(t.total_s for c, t in results[s] if c == plan.segments[s])
                 for s in plan.segments)
    if chosen != plan.meta["predicted_total_s"]:
        fail.append(f"predicted_total_s {plan.meta['predicted_total_s']} != "
                    f"sum of the chosen rows {chosen}")
    # (c) Continue mode on the same DB scores nothing, fuses the same plan
    again = ComParTuner(cfg, shape, device="cuda", db=tuner.db,
                        project=tuner.project, mode="continue",
                        executor="wallclock")
    plan2, rep2 = again.sweep(providers=quickstart.PROVIDERS,
                              clause_space=out["space"], max_flags=1,
                              backend="sequential")
    same = json.dumps(plan2.to_json(), sort_keys=True) == \
        json.dumps(plan.to_json(), sort_keys=True)
    if rep2.n_scored or not same:
        fail.append(f"continue mode scored {rep2.n_scored} programs, same "
                    f"plan: {same}")
    # (d) the sweep and the steps hand their memory back
    if after - before > SWEEP_MEMORY_SLACK:
        fail.append(f"allocated {after / 2**20:.1f} MiB after, "
                    f"{before / 2**20:.1f} before")
    # (e) finite losses; flash-attention launches as the stack clause says
    g0 = plan.segments["g0"].clause
    fa_want = 0 if g0.kernel == "plain" else \
        (2 if g0.remat in ("dots", "full") else 1) * cfg.num_layers
    fa_got = out["launches_per_step"]["flash_attention"]
    if not all(math.isfinite(x) for x in out["losses"]) or fa_got != fa_want:
        fail.append(f"losses {out['losses']}, flash-attention {fa_got} a "
                    f"step, expected {fa_want}")
    line = {"sweep": "A", "arch": cfg.name, "layers": cfg.num_layers,
            "shape": [shape.global_batch, shape.seq_len, shape.kind],
            "n_combinations": rep.n_combinations,
            "unique_programs": rep.n_scored, "n_done": rep.n_done,
            "n_failed": rep.n_failed, "failures": failures,
            "programs": programs, "launches_per_job": per_job,
            "plan": {s: c.label() for s, c in sorted(plan.segments.items())},
            "predicted_total_s": plan.meta["predicted_total_s"],
            "baselines_s": out["baselines"], "sweep_s": out["sweep_s"],
            "train_step_ms": [t * 1e3 for t in out["step_s"]],
            "train_losses": out["losses"],
            "flash_attention_per_step": fa_got,
            "train_peak_gib": out["peak_bytes"] / 2**30, "phase_s": wall,
            "memory_before_mib": before / 2**20,
            "memory_after_mib": after / 2**20,
            "continue_scored": rep2.n_scored, "launches": launches,
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"sweep A granite-8b {cfg.num_layers} layers: {rep.summary()}; "
        f"plan {line['plan']}; sweep {out['sweep_s']:.1f}s; steps "
        f"{[round(t, 1) for t in line['train_step_ms']]} ms; "
        f"{'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"sweep A: {fail}")
    return {"programs": programs, "cfg": cfg, "shape": shape,
            "space": out["space"], "plan": plan}


def _sweep_recurrentgemma(torch, state):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = get_arch("recurrentgemma-2b")
    shape = ShapeConfig(f"prefill-1x{SWEEP_REC_S}", SWEEP_REC_S, 1,
                        "prefill")
    tuner = ComParTuner(cfg, shape, device="cuda", executor="wallclock")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    space = {"remat": ("none",), "kernel": ("plain", "cuda")}
    with _launches_per_job() as per_job:
        plan, rep = tuner.sweep(providers=["tensor_par", "fsdp"],
                                clause_space=space, max_flags=1,
                                backend="sequential")
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    state.setdefault("launches", {})["sweep recurrentgemma-2b"] = launches
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    programs = _programs(tuner)
    fail = _job_launch_gates(cfg, tuner, space, per_job)
    if rep.n_failed or after - before > SWEEP_MEMORY_SLACK:
        fail.append(f"{rep.n_failed} failed rows; allocated "
                    f"{after / 2**20:.1f} MiB after, {before / 2**20:.1f} "
                    f"before")
    segs = {}
    for key, p in programs.items():
        seg, _, kernel = key.split("/")
        segs.setdefault(seg, {})[f"{kernel}_ms"] = p["median_ms"]
    for seg, c in plan.segments.items():
        segs[seg]["chosen"] = c.clause.kernel
    line = {"sweep": "B", "arch": cfg.name, "layers": cfg.num_layers,
            "shape": [shape.global_batch, shape.seq_len, shape.kind],
            "n_combinations": rep.n_combinations,
            "unique_programs": rep.n_scored, "n_done": rep.n_done,
            "n_failed": rep.n_failed, "segments": segs,
            "launches_per_job": per_job,
            "predicted_total_s": plan.meta["predicted_total_s"],
            "sweep_s": wall, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"sweep B recurrentgemma-2b prefill: {rep.summary()}; segments "
        f"{segs}; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"sweep B: {fail}")


def _sweep_dry_run(torch, state, a):
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.examples import quickstart

    cfg, shape = a["cfg"], a["shape"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tuner = ComParTuner(cfg, shape, device="cuda", executor="dryrun")
    t0 = time.perf_counter()
    plan, rep = tuner.sweep(providers=quickstart.PROVIDERS,
                            clause_space=a["space"], max_flags=1)
    wall = time.perf_counter() - t0
    fail = []
    try:
        tight = tuner.audit_soundness()
    except AssertionError as e:
        tight = None
        fail.append(str(e))
    if torch.cuda.memory_allocated() != before:
        fail.append("the dry run allocated device memory")
    jobs = {}
    for r in tuner.db.results(tuner.project):
        cl = r["combo"].clause
        key = f"{r['segment']}/{cl.remat}/{cl.kernel}"
        if key in jobs:
            continue
        c = r["cost"]
        measured = a["programs"].get(key, {}).get("median_ms")
        jobs[key] = {"predicted_ms": c["total_s"] * 1e3,
                     "compute_ms": c["compute_s"] * 1e3,
                     "memory_ms": c["memory_s"] * 1e3, "flops": c["flops"],
                     "bytes": c["bytes_accessed"], "measured_ms": measured,
                     "predicted_over_measured": c["total_s"] * 1e3 / measured
                     if measured else None}
    line = {"sweep": "C", "arch": cfg.name, "hw": tuner.executor.cache_tag,
            "n_combinations": rep.n_combinations,
            "unique_programs": rep.n_scored, "jobs": jobs,
            "plan": {s: c.label() for s, c in sorted(plan.segments.items())},
            "plan_a": {s: c.label() for s, c in
                       sorted(a["plan"].segments.items())},
            "bound_tightness": tight, "sweep_s": wall,
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"sweep C dry run: {rep.summary()}; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"sweep C: {fail}")
    return {"tuner": tuner, "plan": plan, "jobs": jobs}


def phase_tune(torch, state):
    """The tuned-plan loop on the card (see the module docstring): a, the
    machine profile; b, the kernel autotuner on three cells; c, the
    calibrated dry run; d, the lint; e, a plan swept at granite-8b's
    serving shape into a registry, then served from it."""
    import tempfile

    from repro_torch.core.db import SweepDB

    _free_params(torch, state)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        db = SweepDB(str(Path(tmp) / "tune.db"))
        prof = _tune_machine(torch, db)
        _tune_autotune(torch, state, db)
        _tune_calibrated(torch, state, prof)
        _tune_lint(torch, state)
        _tune_registry(torch, state, db, Path(tmp) / "registry.db")
        db.conn.close()


def _tune_machine(torch, db):
    """``load_or_calibrate`` with the full CUDA ladder, gated as readings
    (see TUNE_DATASHEET); a second call must load it from the cache."""
    from repro_torch.core import machine as M

    t0 = time.perf_counter()
    prof = M.load_or_calibrate(db)
    wall = time.perf_counter() - t0
    calls = []
    calibrate = M.calibrate

    def counted(*a, **kw):
        calls.append(1)
        return calibrate(*a, **kw)
    M.calibrate = counted
    try:
        again = M.load_or_calibrate(db)
    finally:
        M.calibrate = calibrate
    read = {"bfloat16": prof.peak_flops.get("bfloat16", 0.0),
            "float32": prof.peak_flops.get("float32", 0.0),
            "hbm": prof.hbm_bw}
    fail = [f"{k} reads {v:.4g}, outside (0, {TUNE_MAX_OVER} x "
            f"{TUNE_DATASHEET[k]:.4g}]" for k, v in read.items()
            if not 0.0 < v <= TUNE_MAX_OVER * TUNE_DATASHEET[k]]
    for k, least in TUNE_LEAST.items():
        if read[k] < least * TUNE_DATASHEET[k]:
            fail.append(f"{k} reads {read[k]:.4g} < {least} x the data "
                        f"sheet: the profile would mislead the dry run")
    if calls or again.pid != prof.pid:
        fail.append(f"the second load_or_calibrate calibrated {len(calls)} "
                    f"times (pid {again.pid[:8]} vs {prof.pid[:8]})")
    hw = M.hardware_from_profile(prof)
    line = {"tune": "machine", "key": prof.key, "pid": prof.pid,
            "hw": hw.name, "bf16_tflop_s": read["bfloat16"] / 1e12,
            "f32_tflop_s": read["float32"] / 1e12,
            "hbm_tb_s": read["hbm"] / 1e12,
            "of_data_sheet": {k: v / TUNE_DATASHEET[k]
                              for k, v in read.items()},
            "calibrated_s": prof.meta["calibrated_s"],
            "load_or_calibrate_s": wall,
            "reloaded_without_calibrating": not calls,
            "meta": prof.meta, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"tune machine: bf16 {line['bf16_tflop_s']:.1f} TFLOP/s, f32 "
        f"{line['f32_tflop_s']:.1f}, HBM {line['hbm_tb_s']:.3f} TB/s in "
        f"{prof.meta['calibrated_s']}s; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"tune machine: {fail}")
    return prof


@contextlib.contextmanager
def _launches_per_variant():
    """Each autotuner measurement's kernel launches (its warm-up and timed
    calls), keyed ``op/variant``: every measurement run inside."""
    import repro_torch.kernels.autotune as AT
    from repro_torch.kernels import LAUNCHES

    per = {}
    measure = AT._measure_one

    def counted(op, fields, cfg, shape, executor):
        n0 = dict(LAUNCHES)
        try:
            return measure(op, fields, cfg, shape, executor)
        finally:
            per[f"{op}/{AT.schedule_key(fields)}"] = {
                k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
    AT._measure_one = counted
    try:
        yield per
    finally:
        AT._measure_one = measure


def _tune_cell(torch, state, db, label, cfg, shape, registry=None):
    """One wall-clock sweep with ``kernel_space="auto", kernel_top_k=2``
    (clause space remat none, providers tensor_par and fsdp) and its gates:
    each cuda measurement launches its kernel once a call and each plain
    one none; an op's cuda keys carry one outcome; no row or variant
    fails; each fused schedule is among its segment's survivors; a second
    sweep on the same DB times nothing.  Returns the fused plan."""
    import repro_torch.kernels.autotune as AT
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.kernels import LAUNCHES, reset_launches

    kw = dict(providers=["tensor_par", "fsdp"], max_flags=0,
              clause_space={"remat": ("none",)}, kernel_space="auto",
              kernel_top_k=2, backend="sequential")
    tuner = ComParTuner(cfg, shape, device="cuda", db=db,
                        project=f"tune-{label}", executor="wallclock",
                        registry=registry)
    tuner.executor.repeats = TUNE_REPEATS
    reset_launches()
    t0 = time.perf_counter()
    with _launches_per_variant() as per:
        plan, rep = tuner.sweep(**kw)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    state.setdefault("launches", {})[f"tune {label}"] = launches
    tuning = tuner._kernel_tuning
    fail = []
    calls = 1 + TUNE_REPEATS                 # the warm-up and the timed
    for key, got in per.items():
        op, vkey = key.split("/", 1)
        want = dict.fromkeys(got, 0)
        if "kernel=cuda" in vkey.split(","):
            want[TUNE_OP_KERNEL[op]] = calls
        if got != want:
            fail.append(f"{key}: launches {got}, expected {want}")
    variants = {}
    for op, res in tuning.variants.items():
        cuda = {json.dumps({k: e.get(k) for k in ("status", "time_s")})
                for v, e in res.items() if "kernel=cuda" in v.split(",")}
        runs = [k for k in per if k.split("/", 1)[0] == op
                and "kernel=cuda" in k.split("/", 1)[1].split(",")]
        if len(cuda) != 1 or len(runs) != 1:
            fail.append(f"{op}: {len(runs)} cuda programs run, "
                        f"{len(cuda)} cuda outcomes")
        variants[op] = {v: {"status": e["status"],
                            "ms": e.get("time_s", 0.0) * 1e3,
                            "shared": e.get("program", v) != v}
                        for v, e in res.items()}
    kt = rep.kernel_tuning
    if rep.n_failed or kt["n_failed"]:
        fail.append(f"{rep.n_failed} failed rows, {kt['n_failed']} failed "
                    f"variants")
    for seg, keep in tuning.surviving.items():
        got = AT.clause_schedule(plan.segments[seg].clause,
                                 tuning.fields[seg])
        if got not in keep:
            fail.append(f"{seg}: plan schedule {got} not among the "
                        f"survivors {sorted(keep)}")
        # the top 2 counts programs: all the tied cuda keys are one, so
        # the cheapest plain schedule survives beside them
        kinds = {k.split("kernel=")[1].split(",")[0] for k in keep}
        if kinds != {"plain", "cuda"}:
            fail.append(f"{seg}: survivors {sorted(keep)} hold the kernels "
                        f"{sorted(kinds)}, expected plain and cuda")
    again = ComParTuner(cfg, shape, device="cuda", db=db,
                        project=f"tune-{label}", mode="continue",
                        executor="wallclock")
    again.executor.repeats = TUNE_REPEATS
    with _launches_per_variant() as per2:
        _, rep2 = again.sweep(**kw)
    if rep2.kernel_tuning["n_timed"] or per2 or rep2.n_scored:
        fail.append(f"second sweep timed {rep2.kernel_tuning['n_timed']} "
                    f"variants ({len(per2)} programs), scored "
                    f"{rep2.n_scored} rows")
    programs = _programs(tuner)
    stack = plan.segments["g0"].clause
    sweep_a = state.get("sweep A", {}).get("programs", {})
    line = {"tune": "autotune", "cell": label, "arch": cfg.name,
            "layers": cfg.num_layers,
            "shape": [shape.global_batch, shape.seq_len, shape.kind],
            "variants": variants, "kernel_tuning": kt,
            "surviving": {k: sorted(v) for k, v in tuning.surviving.items()},
            "plan": {s: c.label() for s, c in sorted(plan.segments.items())},
            "stack": f"{stack.kernel}/{stack.remat}",
            "stack_median_ms": programs.get(
                f"g0/{stack.remat}/{stack.kernel}", {}).get("median_ms"),
            "stack_medians_ms": {k: p["median_ms"]
                                 for k, p in programs.items()
                                 if k.startswith("g0/")},
            "sweep_A_plain_none_ms": sweep_a.get(
                "g0/none/plain", {}).get("median_ms")
            if label == "granite-8b" else None,
            "n_combinations": rep.n_combinations,
            "unique_programs": rep.n_scored, "n_failed": rep.n_failed,
            "programs": programs, "static_rules": rep.static_rules,
            "launches_per_variant": per, "launches": launches,
            "sweep_s": wall, "again_timed": rep2.kernel_tuning["n_timed"],
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"tune autotune {label}: {rep.summary()}; best "
        f"{kt['per_op_best']}; stack {line['stack']} at "
        f"{line['stack_median_ms']} ms (stack medians "
        f"{line['stack_medians_ms']}; sweep A plain/none "
        f"{line['sweep_A_plain_none_ms']} ms); {wall:.1f}s; "
        f"{'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"tune autotune {label}: {fail}")
    return plan


def _tune_autotune(torch, state, db):
    """The autotuner's train and prefill cells (the serving cell is the
    registry's sweep)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig

    cells = [
        ("granite-8b", dataclasses.replace(get_arch("granite-8b"),
                                           num_layers=TRAIN_GRANITE_LAYERS),
         ShapeConfig(f"train-1x{TRAIN_GRANITE_S}", TRAIN_GRANITE_S, 1,
                     "train")),
        ("recurrentgemma-2b", get_arch("recurrentgemma-2b"),
         ShapeConfig(f"prefill-1x{TUNE_PREFILL_S}", TUNE_PREFILL_S, 1,
                     "prefill")),
        ("xlstm-125m", get_arch("xlstm-125m"),
         ShapeConfig(f"prefill-1x{TUNE_XLSTM_S}", TUNE_XLSTM_S, 1,
                     "prefill")),
    ]
    for label, cfg, shape in cells:
        _tune_cell(torch, state, db, label, cfg, shape)
        torch.cuda.empty_cache()


def _stack_ratios(jobs, measured):
    """predicted / measured of each stack job (``g*``) measured in both."""
    return {k: j["predicted_ms"] / measured[k]["median_ms"]
            for k, j in jobs.items() if k.startswith("g")
            and measured.get(k, {}).get("median_ms")}


def _dry_jobs(tuner):
    """One row per unique program of a dry-run sweep: predicted ms."""
    jobs = {}
    for r in tuner.db.results(tuner.project):
        cl = r["combo"].clause
        key = f"{r['segment']}/{cl.remat}/{cl.kernel}"
        if key not in jobs and r["cost"]:
            jobs[key] = {"predicted_ms": r["cost"]["total_s"] * 1e3}
    return jobs


def _quickstart_cell():
    """Sweep A's model, shape and space (``examples/quickstart.py``)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import quickstart
    cfg = dataclasses.replace(get_arch("granite-8b"),
                              num_layers=TRAIN_GRANITE_LAYERS)
    shape = ShapeConfig(f"train-1x{TRAIN_GRANITE_S}", TRAIN_GRANITE_S, 1,
                        "train")
    return cfg, shape, quickstart.SPACE, quickstart.PROVIDERS


def _tune_calibrated(torch, state, prof):
    """Sweep C again with ``machine=`` the profile: its predicted /
    measured against sweep A's medians beside the constant model's, and
    its cache tag and rows apart from the constant model's in one DB."""
    from repro_torch.core.tuner import ComParTuner

    cfg, shape, space, providers = _quickstart_cell()
    kw = dict(providers=providers, clause_space=space, max_flags=1)
    a = state.get("sweep A")
    if a is None:        # sweep A has not run: measure its medians here
        wc = ComParTuner(cfg, shape, device="cuda", executor="wallclock")
        wc.sweep(backend="sequential", **kw)
        measured = _programs(wc)
    else:
        measured = a["programs"]
    c = state.get("sweep C")
    if c is None:        # sweep C has not run: the constant model's here
        const = ComParTuner(cfg, shape, device="cuda", executor="dryrun")
        cplan, _ = const.sweep(**kw)
        c = state["sweep C"] = {"tuner": const, "plan": cplan,
                                "jobs": _dry_jobs(const)}
    const, const_jobs = c["tuner"], c["jobs"]
    cal = ComParTuner(cfg, shape, device="cuda", db=const.db,
                      project="tune-calibrated", executor="dryrun",
                      machine=prof)
    t0 = time.perf_counter()
    plan, rep = cal.sweep(**kw)
    wall = time.perf_counter() - t0
    fail = []
    try:
        tight = cal.audit_soundness()
    except AssertionError as e:
        tight = None
        fail.append(str(e))
    tags = (const.executor.cache_tag, cal.executor.cache_tag)
    envs = dict(const.db.conn.execute(
        "SELECT mesh, COUNT(*) FROM score_cache GROUP BY mesh").fetchall())
    if tags[0] == tags[1] or rep.n_cached or not rep.n_scored or \
            envs.get(f"local/{tags[1]}") != rep.n_scored or \
            set(envs) != {f"local/{t}" for t in tags}:
        fail.append(f"calibrated rows not apart from the constant model's: "
                    f"tags {tags}, cached {rep.n_cached}, scored "
                    f"{rep.n_scored}, score_cache {envs}")
    cal_ratio = _stack_ratios(_dry_jobs(cal), measured)
    const_ratio = _stack_ratios(const_jobs, measured)
    line = {"tune": "calibrated", "hw": tags[1], "constant_hw": tags[0],
            "predicted_over_measured": cal_ratio,
            "constant_predicted_over_measured": const_ratio,
            "medians_from": "sweep A" if a is not None else "this phase",
            "plan": {s: c.label() for s, c in sorted(plan.segments.items())},
            "bound_tightness": tight, "score_cache_rows": envs,
            "sweep_s": wall, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"tune calibrated dry run: predicted/measured {cal_ratio} (constant "
        f"model {const_ratio}); {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"tune calibrated: {fail}")


def _rows_and_plan(tuner, plan):
    return ([(r["segment"], r["cid"], r["status"],
              json.dumps(r["cost"], sort_keys=True))
             for r in tuner.db.results(tuner.project)],
            json.dumps(plan.to_json(), sort_keys=True))


def _tune_lint(torch, state):
    """Sweep A's space as a dry run under "warn" (sweep C, the default
    mode) and "off": the same rows and byte-identical plan JSON; then a
    wall-clock sweep under "strict" whose microbatches=2 point (B=1) is an
    error: its rows are settled "static" and launch nothing."""
    from repro_torch.core.executor import WallClockExecutor
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg, shape, space, providers = _quickstart_cell()
    warn = state["sweep C"]
    off = ComParTuner(cfg, shape, device="cuda", executor="dryrun",
                      project=warn["tuner"].project)
    plan, rep = off.sweep(providers=providers, clause_space=space,
                          max_flags=1, static_checks="off")
    seen = {"warn": _rows_and_plan(warn["tuner"], warn["plan"]),
            "off": _rows_and_plan(off, plan)}
    same = seen["warn"] == seen["off"]
    fail = [] if same else ["warn and off differ in rows or plan"]

    one = dataclasses.replace(cfg, num_layers=1)
    strict = ComParTuner(one, shape, device="cuda", executor="wallclock",
                         project="tune-strict")
    strict.executor.repeats = TUNE_REPEATS
    knobs_seen = []
    score = WallClockExecutor.score_segment

    def counted(self, cfg_, shape_, seg, combo, knobs=None, **k):
        knobs_seen.append(knobs.microbatches if knobs else 1)
        return score(self, cfg_, shape_, seg, combo, knobs=knobs, **k)
    reset_launches()
    WallClockExecutor.score_segment = counted
    try:
        splan, srep = strict.sweep(
            providers=["fsdp"], max_flags=0, backend="sequential",
            clause_space={"remat": ("none",), "kernel": ("cuda",)},
            global_space={"microbatches": (1, 2)}, static_checks="strict")
    finally:
        WallClockExecutor.score_segment = score
    launches = dict(LAUNCHES)
    state.setdefault("launches", {})["tune lint granite-8b"] = launches
    rows = strict.db.results(strict.project)
    mb2 = [r for r in rows if r["knobs"] and r["knobs"].microbatches == 2]
    want_fa = 1 + TUNE_REPEATS                # one layer, mb=1's stack job
    if not mb2 or any(r["status"] != "static" for r in mb2) or \
            srep.n_static != len(mb2) or 2 in knobs_seen or \
            launches["flash_attention"] != want_fa or \
            splan.knobs.microbatches != 1 or srep.n_failed:
        fail.append(f"strict: statuses {[r['status'] for r in mb2]}, "
                    f"n_static {srep.n_static}, jobs at microbatches "
                    f"{knobs_seen}, launches {launches} (flash_attention "
                    f"{want_fa} expected), plan {splan.knobs.key()}")
    line = {"tune": "lint", "warn_equals_off": same,
            "rows": len(seen["warn"][0]),
            "strict_static_rules": srep.static_rules,
            "strict_n_static": srep.n_static,
            "strict_jobs_microbatches": knobs_seen,
            "strict_launches": launches, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"tune lint: warn == off over {len(seen['warn'][0])} rows; strict "
        f"{srep.summary()}; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"tune lint: {fail}")


@contextlib.contextmanager
def _engine_stats():
    """The stats of every ``ServeEngine.run`` called inside, in order."""
    from repro_torch.serve.engine import ServeEngine

    out = []
    run = ServeEngine.run

    def recorded(self, *a, **kw):
        try:
            return run(self, *a, **kw)
        finally:
            out.append(self.stats)
    ServeEngine.run = recorded
    try:
        yield out
    finally:
        ServeEngine.run = run


def _tune_registry(torch, state, db, reg_path):
    """granite-8b at full width and depth swept at its serving shape with
    the kernel axis and ``registry=`` a temporary DB, then served by
    ``launch/serve.py --registry-db`` (batched == sequential), and a
    lookup at capacity 4 resolved to the nearest registered shape."""
    import io

    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import resolve_plan, serve
    from repro_torch.serve.registry import PlanRegistry, serving_shape

    cfg = get_arch("granite-8b")
    shape = serving_shape(TUNE_SERVE_CAPACITY, TUNE_SERVE_CACHE)
    plan = _tune_cell(torch, state, db, "granite-8b serving", cfg, shape,
                      registry=str(reg_path))
    torch.cuda.empty_cache()
    fail = []
    entry = PlanRegistry(str(reg_path)).lookup(cfg, shape)
    if entry is None or not entry.exact or \
            entry.plan.to_json() != plan.to_json():
        fail.append(f"registry entry {entry and entry.describe()} is not the "
                    f"swept plan")
    argv = ["--arch", cfg.name, "--registry-db", str(reg_path),
            "--batch", str(TUNE_SERVE_CAPACITY),
            "--cache-len", str(TUNE_SERVE_CACHE),
            "--requests", str(TUNE_SERVE_N),
            "--prompt-len", str(TUNE_SERVE_PROMPT),
            "--tokens", str(TUNE_SERVE_NEW)]
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _engine_stats() as stats, contextlib.redirect_stdout(out):
        batched = serve(argv)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state.setdefault("launches", {})["tune serve granite-8b"] = launches
    with contextlib.redirect_stdout(io.StringIO()):
        sequential = serve(argv + ["--max-active", "1"])
    printed = out.getvalue()
    st = stats[0]
    kernel = plan.segments["g0"].clause.kernel
    prompt_tokens = st.n_prefill_tokens
    want_fd = cfg.num_layers * prompt_tokens if kernel == "cuda" else 0
    if "plan=registry " not in printed:
        fail.append(f"serve did not take the registered plan: "
                    f"{printed.splitlines()[:1]}")
    if st.n_completed != TUNE_SERVE_N or any(
            len(c.tokens) != TUNE_SERVE_NEW for c in batched.values()):
        fail.append("not every request completed")
    diff = [r for r in batched if batched[r].tokens != sequential[r].tokens]
    if diff:
        fail.append(f"batched streams differ from sequential: {diff}")
    if launches["flash_decode"] != want_fd:
        fail.append(f"flash_decode {launches['flash_decode']} launches, "
                    f"expected {want_fd} ({kernel} plan)")
    _, near = resolve_plan(cfg, serving_shape(4, TUNE_SERVE_CACHE),
                           registry_db=str(reg_path))
    if near != f"registry~decode:{TUNE_SERVE_CACHE}x{TUNE_SERVE_CAPACITY}":
        fail.append(f"lookup at capacity 4 resolved to {near}")
    line = {"tune": "registry", "arch": cfg.name, "layers": cfg.num_layers,
            "shape": entry.shape if entry else None,
            "plan": {s: c.label() for s, c in sorted(plan.segments.items())},
            "stack_kernel": kernel, "served_from": printed.splitlines()[0],
            "capacity_4_resolves_to": near,
            "prefill_tok_s": st.prefill_tok_s,
            "decode_tok_s": st.decode_tok_s, "peak_gib": peak / 2**30,
            "serve_phase": state.get("serve granite-8b"),
            "prompt_tokens": prompt_tokens, "launches": launches,
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"tune registry: served {cfg.name} from {line['served_from']!r}: "
        f"admission {st.prefill_tok_s:.1f} tok/s, decode "
        f"{st.decode_tok_s:.1f} tok/s, peak {peak / 2**30:.2f} GiB; "
        f"capacity 4 -> {near}; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"tune registry: {fail}")


# kernel -> (source, TPU kernel it replaces, the paths that launch it)
def phase_backends(torch, state):
    """The process and remote scoring backends on the card (see the module
    docstring): a, the process backend's dry run against the thread
    backend's; b, its wall clock against an in-process sequential sweep;
    c, a worker killed holding a cuda job; d, the scoring server, a warm
    second client, a chaos proxy and the process fallback; e, the
    ``compar_sweep_json`` and ``train_e2e`` examples."""
    import tempfile

    _free_params(torch, state)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_backends_") as tmp:
        tmp = Path(tmp)
        _backends_dry(torch, state)
        _backends_wallclock(torch, state)
        _backends_kill(torch, state)
        _backends_remote(torch, state, tmp)
        _backends_examples(torch, state, tmp)


def _backends_cell(layers=BACKENDS_LAYERS):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_arch(BACKENDS_ARCH), num_layers=layers)
    shape = ShapeConfig(f"train-{BACKENDS_B}x{BACKENDS_S}", BACKENDS_S,
                        BACKENDS_B, "train")
    return cfg, shape


def _backends_tuner(project, executor="wallclock", db=None,
                    layers=BACKENDS_LAYERS):
    from repro_torch.core.tuner import ComParTuner
    cfg, shape = _backends_cell(layers)
    tuner = ComParTuner(cfg, shape, device="cuda", db=db, project=project,
                        executor=executor)
    if executor == "wallclock":
        tuner.executor.repeats = BACKENDS_REPEATS
    return tuner


def _backends_sweep(tuner, space=BACKENDS_SPACE, **kw):
    return tuner.sweep(providers=["tensor_par", "fsdp"], clause_space=space,
                       global_space=BACKENDS_GLOBALS, max_flags=1, **kw)


def _plan_bytes(plan):
    """The fused decisions (per-segment combinations and knob point)."""
    d = plan.to_json()
    return json.dumps({"segments": d["segments"], "knobs": d["knobs"]},
                      sort_keys=True)


def _medians(tuner):
    """Each unique program's median ms, keyed segment/remat/kernel/mb."""
    return {k: p["median_ms"] for k, p in _programs(tuner, True).items()}


def _backends_dry(torch, state):
    """(a) The process backend (2 workers) against the thread backend (2
    threads), dry run at BACKENDS_DRY_LAYERS layers: the same rows and the
    same plan, byte for byte."""
    seen, info = {}, {}
    for backend in ("thread", "process"):
        t0 = time.perf_counter()
        with _backends_tuner(f"backends-dry-{backend}", "dryrun",
                             layers=BACKENDS_DRY_LAYERS) as tuner:
            plan, rep = _backends_sweep(tuner, backend=backend, workers=2)
            engine = next(iter(tuner._engines.values()), None)
            rows, _ = _rows_and_plan(tuner, plan)
        seen[backend] = (rows, _plan_bytes(plan))
        info[backend] = {"wall_s": time.perf_counter() - t0,
                         "n_combinations": rep.n_combinations,
                         "unique_programs": rep.n_scored,
                         "n_failed": rep.n_failed,
                         "spawn_s": engine.spawn_s if engine else None}
    fail = []
    if seen["thread"] != seen["process"]:
        fail.append("process and thread backends differ in rows or plan")
    if any(i["n_failed"] for i in info.values()):
        fail.append(f"failed rows: {info}")
    line = {"backends": "a", "executor": "dryrun",
            "layers": BACKENDS_DRY_LAYERS, "rows": len(seen["thread"][0]),
            "same_rows_and_plan": not fail, **info, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"backends a (dry run): thread {info['thread']['wall_s']:.1f}s, "
        f"process {info['process']['wall_s']:.1f}s (spawn "
        f"{info['process']['spawn_s']}); {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"backends a: {fail}")


def _backends_wallclock(torch, state):
    """(b) Wall clock on the card: an in-process sequential sweep, then the
    process backend asked for 2 workers (the tuner takes 1).  Every row
    done; the worker's kernel launches, carried back at its shutdown,
    equal the in-process run's, flash-attention's at D=80 above 0."""
    import logging

    from repro_torch.kernels import LAUNCHES, reset_launches

    seq = _backends_tuner("backends-sequential")
    reset_launches()
    t0 = time.perf_counter()
    with _launches_per_job(knobs=True) as per_job:
        plan_s, rep_s = _backends_sweep(seq, backend="sequential")
    wall_s = time.perf_counter() - t0
    seq_launches = dict(LAUNCHES)
    state.setdefault("launches", {})[
        "backends stablelm-3b sequential"] = seq_launches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    clamp = []

    class _Clamp(logging.Handler):
        def emit(self, record):
            clamp.append(record.getMessage())
    handler = _Clamp(logging.WARNING)
    logging.getLogger("repro_torch.tuner").addHandler(handler)
    reset_launches()
    tuner = _backends_tuner("backends-process")
    t0 = time.perf_counter()
    try:
        plan_p, rep_p = _backends_sweep(tuner, backend="process", workers=2)
        engine = next(iter(tuner._engines.values()))
    finally:
        tuner.close()
        logging.getLogger("repro_torch.tuner").removeHandler(handler)
    wall_p = time.perf_counter() - t0
    worker = dict(engine.launches)
    parent = dict(LAUNCHES)
    state["launches"]["backends stablelm-3b"] = worker
    fail = []
    for label, rep in (("sequential", rep_s), ("process", rep_p)):
        if rep.n_failed or rep.n_done != rep.n_combinations:
            fail.append(f"{label}: {rep.n_done} of {rep.n_combinations} "
                        f"rows done, {rep.n_failed} failed")
    if engine.workers != 1 or not any("workers=2 -> 1" in m for m in clamp):
        fail.append(f"pool of {engine.workers} workers; log {clamp}")
    if worker != seq_launches or worker.get("flash_attention", 0) <= 0:
        fail.append(f"worker launches {worker} != in-process {seq_launches}")
    if any(parent.values()):
        fail.append(f"the parent launched {parent} during the process run")
    per_job_fa = sum(j["flash_attention"] for j in per_job.values())
    if per_job_fa != seq_launches["flash_attention"]:
        fail.append(f"per-job flash-attention {per_job_fa} != "
                    f"{seq_launches['flash_attention']}")
    med_s, med_p = _medians(seq), _medians(tuner)
    line = {"backends": "b", "executor": "wallclock", "arch": BACKENDS_ARCH,
            "layers": BACKENDS_LAYERS,
            "shape": [BACKENDS_B, BACKENDS_S, "train"],
            "repeats": BACKENDS_REPEATS,
            "n_combinations": rep_p.n_combinations,
            "unique_programs": rep_p.n_scored, "workers": engine.workers,
            "clamp_log": clamp, "spawn_s": engine.spawn_s,
            "sequential_s": wall_s, "process_s": wall_p,
            "medians_ms": {k: {"process": med_p.get(k), "sequential": v}
                           for k, v in sorted(med_s.items())},
            "plan_process": {s: c.label() for s, c in
                             sorted(plan_p.segments.items())},
            "plan_sequential": {s: c.label() for s, c in
                                sorted(plan_s.segments.items())},
            "knobs": [plan_p.knobs.key(), plan_s.knobs.key()],
            "worker_launches": worker, "sequential_launches": seq_launches,
            "launches_per_job": per_job, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"backends b (wall clock): sequential {wall_s:.1f}s, process "
        f"{wall_p:.1f}s, worker flash-attention {worker['flash_attention']}"
        f" == {seq_launches['flash_attention']}; "
        f"{'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"backends b: {fail}")


def _backends_kill(torch, state):
    """(c) A FaultPlan kills the worker holding the cuda stack job while it
    times it: the job is requeued to a fresh worker and completes; the
    card's free memory after close() agrees with the reading before the
    pool; the parent's CUDA still works."""
    from repro_torch.core.backends import JobSpec, ProcessBackend
    from repro_torch.core.backends.faults import KILL, FaultPlan, FaultRule
    from repro_torch.core.combinator import Combination, GlobalKnobs
    from repro_torch.core.executor import WallClockExecutor
    from repro_torch.core.segment import fragment
    from repro_torch.models.context import SegmentClause

    class KillMidJob(FaultPlan):
        """Fires after the worker has held its job for a while."""
        def fires(self, point):
            rule = super().fires(point)
            if rule is not None:
                time.sleep(BACKENDS_KILL_AFTER_S)
            return rule

    cfg, shape = _backends_cell(BACKENDS_KILL_LAYERS)
    segs = {s.kind: s for s in fragment(cfg)}
    knobs = GlobalKnobs(microbatches=1)

    def job(key, seg, kernel):
        return JobSpec(key, seg, Combination(
            "fsdp", frozenset(), SegmentClause(kernel=kernel)),
            segments=(seg.name,), knobs=knobs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    ex = WallClockExecutor("cuda", repeats=BACKENDS_KILL_REPEATS,
                           timeout_s=600)
    backend = ProcessBackend(ex, cfg, shape, workers=1, timeout_s=600)
    t0 = time.perf_counter()
    try:
        # warm the worker (its CUDA context and libraries) on a cheap job
        warm = list(backend.run([job("embed", segs["embed"], "plain")]))
        backend.fault_plan = KillMidJob(
            {"process.kill_worker": [FaultRule(KILL, at=(1,))]})
        outs = list(backend.run([job("stack", segs["stack"], "cuda")]))
    finally:
        backend.close()
    wall = time.perf_counter() - t0
    free = None
    t1 = time.perf_counter()
    while True:        # a dead process's context is freed as it exits
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        if abs(free - free0) <= SWEEP_MEMORY_SLACK or \
                time.perf_counter() - t1 > 30:
            break
        time.sleep(0.2)
    fail = []
    try:
        x = torch.arange(1024, device="cuda", dtype=torch.float32)
        ok = float(x.sum()) == 1023 * 1024 / 2
        torch.cuda.synchronize()
    except RuntimeError as e:
        ok = False
        fail.append(f"the parent's CUDA failed: {e}")
    if not ok:
        fail.append("the parent's CUDA computed a wrong sum")
    if [o.status for o in warm] != ["done"]:
        fail.append(f"warm-up job: {warm}")
    if [(o.status, o.attempts) for o in outs] != [("done", 2)]:
        fail.append(f"killed job: {[o.to_json() for o in outs]}")
    wids = [w for _, w in backend.dispatch_log]
    if len(set(wids)) != 2:
        fail.append(f"the requeue went to workers {wids}")
    if abs(free - free0) > SWEEP_MEMORY_SLACK:
        fail.append(f"free memory {free / 2**20:.1f} MiB after close, "
                    f"{free0 / 2**20:.1f} before the pool")
    line = {"backends": "c", "repeats": BACKENDS_KILL_REPEATS,
            "kill_after_s": BACKENDS_KILL_AFTER_S,
            "events": backend.fault_plan.events,
            "dispatch_workers": wids,
            "outcome": [o.to_json() for o in outs],
            "free_before_mib": free0 / 2**20, "free_after_mib": free / 2**20,
            "reclaim_s": time.perf_counter() - t1, "wall_s": wall,
            "spawn_s": backend.spawn_s, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"backends c (kill): requeued to worker {wids}, free "
        f"{free0 / 2**20:.0f} -> {free / 2**20:.0f} MiB; "
        f"{'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"backends c: {fail}")


def _start_server(db, log_path):
    """``python -m repro_torch.core.backends.server`` on a free loopback
    port with one worker; returns (process, url) once it listens."""
    import os
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.backends.server",
         "--db", str(db), "--workers", "1", "--port", str(port)],
        env=env, stdout=out, stderr=subprocess.STDOUT, cwd=str(ROOT))
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 120:
        if proc.poll() is not None:
            break
        try:
            if _get(url, "/v1/health").get("ok"):
                return proc, url
        except OSError:
            time.sleep(0.2)
    proc.kill()
    proc.wait()
    raise SmokeFailure(f"scoring server did not start: "
                       f"{Path(log_path).read_text()[-2000:]}")


def _get(url, path):
    import urllib.request
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read())


def _backends_remote(torch, state, tmp):
    """(d) The scoring server (one worker) as a subprocess: a client sweep
    of cell (b) cut to BACKENDS_REMOTE_LAYERS layers with every row done; a
    second client with a fresh DB runs nothing server-side and fuses the
    same plan; so does a third through a seeded chaos proxy; then, the
    server killed, a sweep on the first client's DB with remat "full"
    added falls back to the process backend for exactly the rows its
    cache did not hold."""
    def tuner(project, db=None):
        return _backends_tuner(project, db=db, layers=BACKENDS_REMOTE_LAYERS)

    from repro_torch.core.backends import RetryPolicy
    from repro_torch.core.backends.faults import (DROP, ERROR, ChaosProxy,
                                                  FaultPlan, FaultRule)
    from repro_torch.core.db import SweepDB

    t0 = time.perf_counter()
    proc, url = _start_server(tmp / "server.db", tmp / "server.log")
    fail, info = [], {"server_start_s": time.perf_counter() - t0}
    try:
        t0 = time.perf_counter()
        c1 = tuner("backends-remote-1", db=SweepDB(str(tmp / "client.db")))
        plan1, rep1 = _backends_sweep(c1, remote_url=url)
        info["client_1"] = {"wall_s": time.perf_counter() - t0,
                            "summary": rep1.summary(),
                            "medians_ms": _medians(c1)}
        stats1 = _get(url, "/v1/stats")
        if rep1.n_failed or rep1.n_done != rep1.n_combinations:
            fail.append(f"client 1: {rep1.summary()}")
        t0 = time.perf_counter()
        plan2, rep2 = _backends_sweep(tuner("backends-remote-2"),
                                      remote_url=url)
        stats2 = _get(url, "/v1/stats")
        info["client_2"] = {"wall_s": time.perf_counter() - t0,
                            "summary": rep2.summary()}
        if stats2["n_compiled"] != stats1["n_compiled"] or rep2.n_scored \
                or _plan_bytes(plan2) != _plan_bytes(plan1):
            fail.append(f"warm client: n_compiled {stats1['n_compiled']} "
                        f"-> {stats2['n_compiled']}, scored "
                        f"{rep2.n_scored}, same plan "
                        f"{_plan_bytes(plan2) == _plan_bytes(plan1)}")
        chaos = FaultPlan({"proxy": [
            FaultRule(DROP, rate=BACKENDS_CHAOS_RATE),
            FaultRule(ERROR, rate=BACKENDS_CHAOS_RATE)]},
            seed=BACKENDS_CHAOS_SEED)
        proxy = ChaosProxy(url, chaos)
        proxy.start()
        try:
            plan3, rep3 = _backends_sweep(
                tuner("backends-remote-chaos"),
                remote_url=proxy.url,
                retry=RetryPolicy(budget_s=30.0, base_s=0.05, cap_s=0.25))
        finally:
            proxy.close()
        info["chaos"] = {"events": chaos.events, "summary": rep3.summary()}
        if _plan_bytes(plan3) != _plan_bytes(plan1) or rep3.n_failed or \
                not chaos.events:
            fail.append(f"chaos client: {rep3.summary()}, events "
                        f"{chaos.events}")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    info["server_exit"] = proc.returncode
    info["stats"] = {"after_client_1": stats1, "after_client_2": stats2}
    t0 = time.perf_counter()
    with tuner("backends-fallback",
               db=SweepDB(str(tmp / "client.db"))) as c4:
        plan4, rep4 = _backends_sweep(
            c4, space=dict(BACKENDS_SPACE, remat=("none", "dots", "full")),
            remote_url=url, fallback="process",
            retry=RetryPolicy(budget_s=2.0, base_s=0.05, cap_s=0.2))
    info["fallback"] = {"wall_s": time.perf_counter() - t0,
                        "summary": rep4.summary(),
                        "n_fallback_local": rep4.n_fallback_local,
                        "n_cached": rep4.n_cached,
                        "n_combinations": rep4.n_combinations,
                        "plan": {s: c.label() for s, c in
                                 sorted(plan4.segments.items())}}
    left = rep4.n_combinations - rep4.n_cached
    if rep4.n_failed or rep4.n_done != rep4.n_combinations or \
            rep4.n_fallback_local != left or not left or \
            set(plan4.segments) != set(plan1.segments):
        fail.append(f"fallback: {rep4.summary()}, {left} rows left")
    line = {"backends": "d", "server_workers": 1,
            "layers": BACKENDS_REMOTE_LAYERS, **info,
            "plan": {s: c.label() for s, c in sorted(plan1.segments.items())},
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"backends d (remote): client 1 {info['client_1']['wall_s']:.1f}s, "
        f"warm client {info['client_2']['wall_s']:.1f}s, chaos events "
        f"{len(chaos.events)}, fallback {rep4.n_fallback_local} of "
        f"{rep4.n_combinations} rows; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"backends d: {fail}")


def _failed_rows(db_path):
    """segment/clause/knobs -> error of each failed row of a sweep DB."""
    from repro_torch.core.db import SweepDB
    db = SweepDB(str(db_path))
    try:
        return {f"{r['segment']}/{r['combo'].label()}/"
                f"{r['knobs'].key() if r['knobs'] else ''}": r["error"][:300]
                for p in ("json-demo",) for r in db.results(p)
                if r["status"] == "failed"}
    finally:
        db.conn.close()


def _backends_examples(torch, state, tmp):
    """(e) ``python -m repro_torch.examples.compar_sweep_json --backend
    process --layers 1`` on the card, the reference's spec (block_q 16)
    with kernel {plain, cuda} (rc 0, no failed row, the Continue run
    scores nothing) and ``python -m repro_torch.examples.train_e2e --full
    --steps BACKENDS_E2E_STEPS`` (finite losses, the restart resumes from
    its checkpoint)."""
    import os

    work = tmp / "examples"
    work.mkdir()
    env = dict(os.environ, TMPDIR=str(work), PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    fail, info = [], {}
    for name, args in (("compar_sweep_json", ["--backend", "process",
                                              "--layers",
                                              str(BACKENDS_EXAMPLE_LAYERS)]),
                       ("train_e2e", ["--full", "--steps",
                                      str(BACKENDS_E2E_STEPS)])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            f"repro_torch.examples.{name}", *args],
                           env=env, cwd=str(ROOT), capture_output=True,
                           text=True, timeout=900)
        out = r.stdout + r.stderr
        info[name] = {"rc": r.returncode, "wall_s": time.perf_counter() - t0}
        if r.returncode != 0:
            fail.append(f"{name}: rc {r.returncode}: {out[-3000:]}")
            continue
        if name == "compar_sweep_json":
            first = [ln for ln in out.splitlines()
                     if ln.startswith("first run:")]
            cont = [ln for ln in out.splitlines()
                    if ln.startswith("continue run:")]
            info[name].update(first=first, cont=cont,
                              failed_rows=_failed_rows(
                                  work / "compar_sweep.db"))
            if not cont or " scored=0 " not in cont[0] or not first or \
                    " failed=0 " not in first[0]:
                fail.append(f"{name}: {first} / {cont} / "
                            f"{info[name]['failed_rows']}")
        else:
            losses = [float(m) for m in re.findall(r"loss=([-\w.+]+)", out)]
            resumed = re.findall(r"resumed from step (\d+)", out)
            info[name].update(losses=losses, resumed=resumed)
            if not losses or not all(math.isfinite(x) for x in losses) or \
                    resumed != [str(BACKENDS_E2E_STEPS // 2)]:
                fail.append(f"{name}: losses {losses}, resumed {resumed}")
    line = {"backends": "e", **info, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"backends e (examples): "
        f"{ {k: round(v['wall_s'], 1) for k, v in info.items()} }; "
        f"{'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"backends e: {fail}")


def phase_mesh(torch, state):
    """The port on a (1, 1) DeviceMesh of a world-size-1 NCCL group (see
    the module docstring); the group goes at the end, pass or fail."""
    from repro_torch.core.meshspec import MeshSpec
    from repro_torch.launch.mesh import destroy_group, device_mesh
    _free_params(torch, state)
    t0 = time.perf_counter()
    mesh = device_mesh((1, 1), ("data", "model"), "cuda")
    spec = MeshSpec.from_mesh(mesh)
    import torch.distributed as dist
    line = {"mesh": "group", "backend": dist.get_backend(),
            "world_size": dist.get_world_size(), "key": spec.key(),
            "mid": spec.mid, "shape": list(mesh.shape),
            "axes": list(mesh.mesh_dim_names),
            "group_s": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    log(f"mesh: {line}")
    import tempfile
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    dry = None
    try:
        for part, run, arg in (("prefill", _mesh_prefill, mesh),
                               ("dryrun start", _dryrun_start, tmp.name),
                               ("serve", _mesh_serve, mesh),
                               ("a2a", _mesh_a2a, mesh),
                               ("shardmap", _mesh_shardmap, mesh),
                               ("train", _mesh_train, mesh),
                               ("sweep", _mesh_sweep, spec),
                               ("dryrun", _dryrun_check, None)):
            t0 = time.perf_counter()
            if part == "dryrun start":
                dry = run(torch, state, arg)
            else:
                run(torch, state, dry if part == "dryrun" else arg)
            log(f"mesh: part {part} {time.perf_counter() - t0:.1f}s")
    finally:
        destroy_group()
        left = stop_descendants()
        tmp.cleanup()
    if left:
        raise SmokeFailure(f"mesh: processes left: {left}")
    log("mesh: group destroyed, no process left")


def _mesh_plan(cfg, provider, kernel="cuda", remat="none"):
    from repro_torch.core.plan import uniform_plan
    from repro_torch.models.context import SegmentClause
    return uniform_plan(cfg, provider, frozenset(),
                        SegmentClause(remat=remat, kernel=kernel))


def _placed(cfg, params, plan, mesh):
    """``params`` as DTensors by ``plan``'s rules, and the count of leaves
    by placement."""
    from collections import Counter
    from repro_torch.core.plan import segment_rules
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import place_params, tree_leaves
    placed = place_params(params, model_specs(cfg),
                          segment_rules(cfg, plan, mesh))
    counts = Counter(str(tuple(t.placements)) for t in tree_leaves(placed))
    return placed, dict(sorted(counts.items()))


def _mesh_prefill(torch, state, mesh):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.step import make_prefill
    cfg = get_arch("granite-8b")
    params = _params(torch, cfg, state)
    gen = torch.Generator().manual_seed(7)
    S = 2048
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen).cuda()
    gib = lambda: torch.cuda.memory_allocated() / 2**30    # noqa: E731

    def timed(fn, p, label):
        """A warm-up call, then one timed call of ``fn`` on the S tokens,
        and one more under the profiler (its idle share)."""
        with torch.no_grad():
            fn(p, {"tokens": tokens[:, :128]})
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = fn(p, {"tokens": tokens})
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            trace = _profile_prefill(torch, fn, p, tokens, label)
        return out, dt * 1e3, launches, trace

    want, want_ms, _, want_trace = timed(
        make_prefill(cfg, _mesh_plan(cfg, "tensor_par")), params,
        "granite-8b meshless")
    fail, parts = [], {}
    for provider in ("tensor_par", "fsdp"):
        plan = _mesh_plan(cfg, provider)
        before = gib()
        placed, counts = _placed(cfg, params, plan, mesh)
        torch.cuda.synchronize()
        placed_gib = gib() - before
        got, dt, launches, trace = timed(
            make_prefill(cfg, plan, mesh=mesh), placed,
            f"granite-8b mesh {provider}")
        state.setdefault("launches", {})[
            f"mesh prefill granite-8b {provider}"] = launches
        diff = (got - want).abs()
        ok = bool((diff <= PREFILL_ATOL + PREFILL_RTOL * want.abs()).all())
        parts[provider] = {"leaves_by_placement": counts,
                           "prefill_ms": dt,
                           "profiled": trace,
                           "allocated_by_placing_gib": placed_gib,
                           "max_abs_diff": float(diff.max()),
                           "finite": bool(torch.isfinite(got).all()),
                           "launches": launches}
        if not ok:
            fail.append(f"{provider}: logits differ from meshless "
                        f"(max {float(diff.max()):.4g})")
        if launches["flash_attention"] != cfg.num_layers:
            fail.append(f"{provider}: {launches['flash_attention']} "
                        f"flash-attention launches, expected "
                        f"{cfg.num_layers}")
        del placed, got
        torch.cuda.empty_cache()
    line = {"mesh": "prefill", "arch": cfg.name, "layers": cfg.num_layers,
            "B": 1, "S": S, "plan_kernel": "cuda",
            "meshless": {"prefill_ms": want_ms, "profiled": want_trace},
            "providers": parts,
            "atol": PREFILL_ATOL, "rtol": PREFILL_RTOL, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"mesh prefill: {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"mesh prefill: {fail}")


def _mesh_serve(torch, state, mesh):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import ServeEngine
    cfg = get_arch("granite-8b")
    plan = _mesh_plan(cfg, "tensor_par")
    gib = lambda: torch.cuda.memory_allocated() / 2**30    # noqa: E731
    params = _params(torch, cfg, state)
    alloc = {"weights": gib()}
    placed, _ = _placed(cfg, params, plan, mesh)
    alloc["placed"] = gib()
    eng = ServeEngine(cfg, plan, capacity=8, cache_len=2048, params=placed,
                      mesh=mesh)
    alloc["engine"] = gib()
    reqs = synthetic_requests(8, cfg.vocab_size, prompt_len=MESH_PROMPT,
                              tokens=MESH_NEW, seed=3)
    eng.run(reqs[:1])                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    batched = eng.run(reqs)
    launches = dict(LAUNCHES)
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()
    sequential = eng.run(reqs, max_active=1)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    state.setdefault("launches", {})["mesh serve granite-8b"] = launches
    fail = []
    if st.n_completed != len(reqs) or any(
            len(batched[r.rid].tokens) != r.max_new_tokens for r in reqs):
        fail.append("not every request completed")
    diff = [r.rid for r in reqs
            if batched[r.rid].tokens != sequential[r.rid].tokens]
    if diff:
        fail.append(f"batched streams differ from sequential: {diff}")
    if launches["flash_decode"] != cfg.num_layers * prompt_tokens:
        fail.append(f"{launches['flash_decode']} flash-decode launches, "
                    f"expected {cfg.num_layers * prompt_tokens}")
    line = {"mesh": "serve", "arch": cfg.name, "provider": "tensor_par",
            "requests": len(reqs), "prompt_tokens": prompt_tokens,
            "new_tokens": MESH_NEW, "prefill_tok_s": st.prefill_tok_s,
            "decode_tok_s": st.decode_tok_s, "elapsed_s": st.elapsed_s,
            "peak_gib": peak / 2**30, "allocated_gib": alloc,
            "launches": launches,
            "batched_eq_sequential": not diff, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"mesh serve: {st.summary()}; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"mesh serve: {fail}")


def _mesh_grads(torch, cfg, plan, params, batch, mesh, meshless=None):
    """Step-0 grads of ``plan`` on ``mesh`` against meshless (under
    ``meshless``, ``plan`` by default), same weights and batch: (worst
    per-leaf relative L2, the rows, the losses)."""
    from repro_torch.core.plan import segment_rules
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import (place_params, tree_leaves,
                                           tree_map_with_path)
    from repro_torch.runtime.sharding import full
    from repro_torch.train.step import make_grads, place_batch
    loss0, _, g0 = make_grads(cfg, meshless or plan, device="cuda")(
        params, batch)
    placed = place_params(params, model_specs(cfg),
                          segment_rules(cfg, plan, mesh))
    loss1, _, g1 = make_grads(cfg, plan, device="cuda", mesh=mesh)(
        placed, place_batch(batch, cfg, plan, mesh))
    paths = tree_leaves(tree_map_with_path(lambda p, _: "/".join(p),
                                           model_specs(cfg)))
    worst, rows = 0.0, {}
    for path, a, b in zip(paths, tree_leaves(g0), tree_leaves(g1)):
        b = full(b).float()
        rel = float((b - a.float()).norm() / a.float().norm())
        rows[path] = rel
        worst = max(worst, rel)
    return worst, rows, (float(loss0), float(loss1))


def _mesh_train(torch, state, mesh):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        place_batch)
    _free_params(torch, state)          # the full model's weights go first
    full_cfg = get_arch("granite-8b")
    fail, gates = [], {}
    for layers, dt in ((1, "float32"), (MESH_TRAIN_LAYERS, "bfloat16")):
        cfg = dataclasses.replace(full_cfg, num_layers=layers, dtype=dt)
        plan = _mesh_plan(cfg, "tensor_par", remat="dots")
        params, _ = init_train_state(cfg, plan,
                                     torch.Generator().manual_seed(0), "cuda")
        batch = _train_data(cfg, MESH_S).batch_at(0)
        worst, rows, losses = _mesh_grads(torch, cfg, plan, params, batch,
                                          mesh)
        bound = TRAIN_GRAD_REL_L2[dt]
        gates[f"{layers} layers {dt}"] = {"worst_rel_l2": worst,
                                          "bound": bound, "losses": losses,
                                          "per_leaf": rows}
        if not worst < bound:
            fail.append(f"{layers} layers {dt}: grads rel L2 {worst:.3g} "
                        f">= {bound}")
        del params
        torch.cuda.empty_cache()
    plan = _mesh_plan(cfg, "tensor_par", remat="dots")
    params, opt = init_train_state(cfg, plan,
                                   torch.Generator().manual_seed(0), "cuda",
                                   mesh=mesh)
    step = make_train_step(cfg, plan, device="cuda", mesh=mesh)
    data = _train_data(cfg, MESH_S)
    reset_launches()
    losses, times = [], []
    for s in range(2):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt,
                              place_batch(data.batch_at(s), cfg, plan, mesh))
        losses.append(float(m["total_loss"]))
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    state.setdefault("launches", {})["mesh train granite-8b"] = launches
    if not all(math.isfinite(x) for x in losses) or opt.step != 2:
        fail.append(f"AdamW steps: losses {losses}, step {opt.step}")
    line = {"mesh": "train", "arch": cfg.name, "S": MESH_S,
            "provider": "tensor_par", "remat": "dots", "grads": gates,
            "adamw_losses": losses, "step_ms": [t * 1e3 for t in times],
            "launches": launches, "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"mesh train: {[(k, v['worst_rel_l2']) for k, v in gates.items()]}"
        f", AdamW losses {losses}; {'ok' if not fail else 'FAIL'}")
    del params, opt
    torch.cuda.empty_cache()
    if fail:
        raise SmokeFailure(f"mesh train: {fail}")


def _moe_plan(cfg, dispatch, remat="none"):
    """qwen3's expert_par plan, "cuda" kernels, ``moe_dispatch``."""
    from repro_torch.core.plan import uniform_plan
    from repro_torch.models.context import SegmentClause
    return uniform_plan(cfg, "expert_par", frozenset(), SegmentClause(
        remat=remat, kernel="cuda", moe_dispatch=dispatch))


def _mesh_a2a(torch, state, mesh):
    """(a) The all-to-all MoE dispatch on the (1, 1) mesh: qwen3-moe-30b-a3b
    at full width cut to MESH_MOE_LAYERS, prefill B=1 under ``expert_par``
    with ``moe_dispatch="a2a"`` (routed in f32, as the reference's)
    against the same weights meshless and sorted (routed in bf16): the
    expert-set agreement of the two routings, and the logits with the
    sorted run's routing replayed in the a2a run (PREFILL_ATOL/RTOL),
    exactly MESH_MOE_LAYERS flash-attention launches; then the step-0
    grads of MESH_MOE_TRAIN_LAYERS in f32, a2a on the mesh (its sum over
    ``model`` a real one-rank NCCL all-reduce) against sorted meshless
    (TRAIN_GRAD_REL_L2)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve.step import make_prefill
    from repro_torch.train.step import init_train_state
    _free_params(torch, state)
    cfg = dataclasses.replace(get_arch(MOE), num_layers=MESH_MOE_LAYERS)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cuda")
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (1, MESH_MOE_S),
                           generator=gen).cuda()
    plan = _moe_plan(cfg, "a2a")
    r_sorted, r_a2a = [], []
    with torch.no_grad():
        with _routes("record", r_sorted):
            want = make_prefill(cfg, _moe_plan(cfg, "sorted"))(
                params, {"tokens": tokens})
        placed, counts = _placed(cfg, params, plan, mesh)
        fn = make_prefill(cfg, plan, mesh=mesh)
        fn(placed, {"tokens": tokens[:, :128]})              # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with _routes("record", r_a2a):
            got = fn(placed, {"tokens": tokens})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        with _routes("replay", list(r_sorted)):
            forced = fn(placed, {"tokens": tokens})
    state.setdefault("launches", {})[f"mesh a2a {MOE}"] = launches
    per_layer, agree = _agreement(torch, r_sorted, r_a2a)
    diff = (forced - want).abs()
    fail = []
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= PREFILL_ATOL + PREFILL_RTOL * want.abs()).all())
    if not ok:
        fail.append(f"a2a logits with the sorted routing replayed differ "
                    f"from sorted meshless (max {float(diff.max()):.4g})")
    if min(per_layer) < MESH_A2A_AGREE_MIN:
        fail.append(f"expert sets agree {min(per_layer):.4f} < "
                    f"{MESH_A2A_AGREE_MIN}")
    if launches["flash_attention"] != cfg.num_layers:
        fail.append(f"{launches['flash_attention']} flash-attention "
                    f"launches, expected {cfg.num_layers}")
    del placed, got, forced, want, params
    torch.cuda.empty_cache()
    # step-0 grads, f32, a2a on the mesh against sorted meshless
    cfg2 = dataclasses.replace(get_arch(MOE), num_layers=MESH_MOE_TRAIN_LAYERS,
                               dtype="float32")
    p2, _ = init_train_state(cfg2, _moe_plan(cfg2, "sorted"),
                             torch.Generator().manual_seed(0), "cuda")
    batch = _train_data(cfg2, MESH_MOE_S).batch_at(0)
    reset_launches()
    worst, rows, losses = _mesh_grads(
        torch, cfg2, _moe_plan(cfg2, "a2a"), p2, batch, mesh,
        meshless=_moe_plan(cfg2, "sorted"))
    bound = TRAIN_GRAD_REL_L2["float32"]
    if not worst < bound:
        fail.append(f"grads rel L2 {worst:.3g} >= {bound}")
    del p2
    torch.cuda.empty_cache()
    line = {"mesh": "a2a", "arch": cfg.name, "layers": cfg.num_layers,
            "B": 1, "S": MESH_MOE_S, "provider": "expert_par",
            "leaves_by_placement": counts, "prefill_ms": dt * 1e3,
            "expert_sets_agree_per_layer": per_layer,
            "tokens_agreeing_every_layer": float(agree.float().mean()),
            "replayed_max_abs_diff": float(diff.max()),
            "replayed_mean_abs_diff": float(diff.mean()),
            "atol": PREFILL_ATOL, "rtol": PREFILL_RTOL,
            "launches": launches,
            "grads": {"layers": MESH_MOE_TRAIN_LAYERS, "dtype": "float32",
                      "worst_rel_l2": worst, "bound": bound,
                      "losses": losses, "per_leaf": rows},
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"mesh a2a: agree {min(per_layer):.4f}, replayed max "
        f"{float(diff.max()):.4g}, grads {worst:.3g}; "
        f"{'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"mesh a2a: {fail}")


def _mesh_shardmap(torch, state, mesh):
    """(b) ``decode_shardmap`` on the (1, 1) mesh: one granite-8b attention
    layer at full width, rules with ``kv_seq`` on ``model`` (as
    tests/test_optimizations.py's), MESH_DSM_STEPS positions at B=8 of a
    MESH_DSM_SMAX cache against the same layer meshless on the
    ``kernel="cuda"`` path (flash-decode): outputs at the flash-decode
    bf16 tolerance, caches exactly equal, flash-decode launched once a
    position on the meshless side and never on the sharded one."""
    from repro_torch.configs import get_arch
    from repro_torch.core.plan import build_contexts
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import attention as A
    from repro_torch.models.context import ModelContext, SegmentClause
    from repro_torch.models.params import init_params
    from repro_torch.runtime.sharding import full, mesh_scope
    cfg = get_arch("granite-8b")
    p = init_params(A.attn_specs(cfg), torch.Generator().manual_seed(0),
                    "cuda")
    B, Smax, N = MESH_DSM_B, MESH_DSM_SMAX, MESH_DSM_STEPS
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    rules = build_contexts(cfg, _mesh_plan(cfg, "tensor_par"), mesh)[
        "g0"].rules.merged({"kv_seq": "model", "kv_heads": None})
    ctx0 = ModelContext(clause=SegmentClause(kernel="cuda"))
    ctx1 = ModelContext(rules=rules, clause=SegmentClause(
        kernel="cuda", decode_shardmap=True))
    axes = ("batch", "kv_seq", "kv_heads", None)

    def zeros():
        return torch.zeros(B, Smax, KV, D, dtype=torch.bfloat16,
                           device="cuda")
    c0 = {"k": zeros(), "v": zeros()}
    c1 = {n: rules.distribute(zeros(), axes) for n in ("k", "v")}
    if not A._seq_sharded(ctx1, c1):
        raise SmokeFailure("mesh shardmap: the rules do not split kv_seq")
    gen = torch.Generator().manual_seed(11)
    xs = (torch.randn(N, B, cfg.d_model, generator=gen) * 0.3).to(
        torch.bfloat16).cuda()
    worst, fd, t = 0.0, [0, 0], [0.0, 0.0]
    ok = True
    with torch.no_grad():
        for pos in range(N):
            reset_launches()
            t0 = time.perf_counter()
            y0, c0 = A.attn_decode(p, xs[pos], c0, pos, cfg, ctx0)
            torch.cuda.synchronize()
            t[0] += time.perf_counter() - t0
            fd[0] += LAUNCHES["flash_decode"]
            reset_launches()
            t0 = time.perf_counter()
            with mesh_scope(True):
                y1, c1 = A.attn_decode(p, xs[pos], c1, pos, cfg, ctx1)
                y1 = full(y1)
            torch.cuda.synchronize()
            t[1] += time.perf_counter() - t0
            fd[1] += LAUNCHES["flash_decode"]
            err, good = max_err(torch, y1, y0, "bfloat16")
            worst, ok = max(worst, err), ok and good
    same = all(torch.equal(full(c1[n]), c0[n]) for n in ("k", "v"))
    state.setdefault("launches", {})["mesh shardmap granite-8b"] = {
        **{k: 0 for k in LAUNCHES}, "flash_decode": fd[0] + fd[1]}
    fail = []
    if not ok:
        fail.append(f"outputs differ past the bf16 tolerance (max "
                    f"{worst:.4g})")
    if not same:
        fail.append("caches differ")
    if fd != [N, 0]:
        fail.append(f"flash-decode launches {fd}, expected [{N}, 0]")
    line = {"mesh": "shardmap", "arch": cfg.name, "B": B, "Smax": Smax,
            "positions": N, "max_abs_err": worst, "tol": TOL["bfloat16"],
            "caches_equal": same, "flash_decode_launches": {
                "meshless": fd[0], "shardmap": fd[1]},
            "ms_per_position": {"meshless_flash_decode": t[0] / N * 1e3,
                                "shardmap": t[1] / N * 1e3},
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"mesh shardmap: max_abs_err {worst:.4g}, caches equal {same}; "
        f"{'ok' if not fail else 'FAIL'}")
    del p, c0, c1
    torch.cuda.empty_cache()
    if fail:
        raise SmokeFailure(f"mesh shardmap: {fail}")


def _dryrun_plans(tmp):
    """The dry run's plan files: granite-8b decode_32k's default plan with
    ``decode_shardmap``, qwen3-moe-30b-a3b's with ``moe_dispatch="a2a"``."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.plan import Plan
    from repro_torch.launch.dryrun import default_plan

    def with_clause(arch, **fields):
        base = default_plan(get_arch(arch), get_shape("decode_32k"))
        plan = Plan({k: dataclasses.replace(c, clause=dataclasses.replace(
            c.clause, **fields)) for k, c in base.segments.items()},
            base.knobs)
        path = str(Path(tmp) / f"{arch}.plan.json")
        plan.save(path)
        return path
    return (with_clause("granite-8b", decode_shardmap=True),
            with_clause(MOE, moe_dispatch="a2a"))


def _dryrun_start(torch, state, tmp):
    """(c) ``python -m repro_torch.launch.dryrun --device cuda`` as three
    subprocesses at once (a fake group cannot share a process with the
    NCCL group): granite-8b decode_32k on the (16, 16) and (2, 16, 16)
    meshes under the default plan; granite-8b decode_32k with
    ``decode_shardmap``; qwen3-moe-30b-a3b decode_32k with the all-to-all
    dispatch.  Returns the running processes; :func:`_dryrun_check`
    waits for them."""
    import os
    dsm, a2a = _dryrun_plans(tmp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    runs = {"granite-8b default": ["--arch", "granite-8b", "--both-meshes"],
            "granite-8b decode_shardmap": ["--arch", "granite-8b",
                                           "--plan", dsm],
            "qwen3-moe-30b-a3b a2a": ["--arch", MOE, "--plan", a2a]}
    procs = {}
    for label, args in runs.items():
        out = Path(tmp) / f"{label.replace(' ', '_')}.json"
        logf = open(Path(tmp) / f"{label.replace(' ', '_')}.log", "w")
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             "cuda", "--shape", "decode_32k", "--out", str(out), *args],
            env=env, cwd=str(ROOT), stdout=logf, stderr=subprocess.STDOUT),
            out, logf, time.perf_counter())
    return procs


def _dryrun_check(torch, state, procs):
    """(c) The dry-run cells: each cell's status and collective bytes by
    kind, and the granite-8b cells held to the arithmetic of
    DRYRUN_GATHER_MIN_BYTES / DRYRUN_DSM_MAX_BYTES."""
    cells, fail, walls = {}, [], {}
    for label, (proc, out, logf, t0) in procs.items():
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        logf.close()
        # an upper bound: the process may have ended long before it is read
        walls[label] = time.perf_counter() - t0
        text = Path(logf.name).read_text()
        if rc != 0 or not out.exists():
            fail.append(f"{label}: rc {rc}: {text[-1500:]}")
            continue
        for key, rec in json.loads(out.read_text()).items():
            cells[f"{label} | {key}"] = {
                "status": rec["status"], "chips": rec.get("chips"),
                "elapsed_s": rec.get("elapsed_s"),
                "collective_bytes": rec.get("cost", {}).get(
                    "collective_bytes"),
                "coll": {k: v for k, v in rec.get("detail", {}).items()
                         if k.startswith("coll_")},
                "peak_bytes": rec.get("detail", {}).get("peak_bytes"),
                "dominant": rec.get("dominant")}
    plain = cells.get("granite-8b default | granite-8b|decode_32k|single")
    dsm = cells.get("granite-8b decode_shardmap | "
                    "granite-8b|decode_32k|single")
    if plain is None or dsm is None:
        fail.append("the granite-8b cells are missing")
    else:
        gather = plain["coll"].get("coll_all-gather", 0.0)
        if gather < DRYRUN_GATHER_MIN_BYTES:
            fail.append(f"without decode_shardmap: all-gather {gather:.4g} "
                        f"B < {DRYRUN_GATHER_MIN_BYTES}")
        if dsm["collective_bytes"] > DRYRUN_DSM_MAX_BYTES or \
                dsm["coll"].get("coll_all-gather", 0.0) > \
                DRYRUN_DSM_MAX_BYTES:
            fail.append(f"with decode_shardmap: collectives "
                        f"{dsm['collective_bytes']:.4g} B, {dsm['coll']}")
    for key, c in cells.items():
        if c["status"] != "ok":
            fail.append(f"{key}: {c['status']}")
    line = {"mesh": "dryrun", "device": "cuda", "cells": cells,
            "start_to_read_s": walls, "gather_min_bytes":
            DRYRUN_GATHER_MIN_BYTES, "dsm_max_bytes": DRYRUN_DSM_MAX_BYTES,
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    for key, c in cells.items():
        log(f"dryrun {key}: {c['status']} "
            f"{ {k: round(v / 2**20, 3) for k, v in c['coll'].items()} } "
            f"MiB")
    if fail:
        raise SmokeFailure(f"mesh dryrun: {fail}")


def _mesh_sweep(torch, state, spec):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = dataclasses.replace(get_arch("granite-8b"),
                              num_layers=MESH_TRAIN_LAYERS)
    shape = ShapeConfig(f"train-1x{MESH_S}", MESH_S, 1, "train")
    space = {"remat": ("none",), "kernel": ("plain", "cuda")}
    points = [None, MESH_POINT]
    kw = dict(providers=["tensor_par", "fsdp"], clause_space=space,
              max_flags=0, mesh_space=points)
    fail = []
    reset_launches()
    t0 = time.perf_counter()
    with ComParTuner(cfg, shape, device="cuda", executor="wallclock",
                     timeout_s=600) as tuner:
        plan, rep = tuner.sweep(**kw)
        rows = _mesh_rows(tuner)
    wall = time.perf_counter() - t0
    state.setdefault("launches", {})["mesh sweep granite-8b"] = \
        dict(LAUNCHES)
    if rep.n_done != rep.n_combinations:
        fail.append(f"wall clock: {rep.n_done} of {rep.n_combinations} "
                    f"rows done")
    dry = {}
    for backend in ("sequential", "process"):
        t1 = time.perf_counter()
        with ComParTuner(cfg, shape, device="cuda", executor="dryrun",
                         timeout_s=600) as dt:
            p, r = dt.sweep(backend=backend, workers=2, **kw)
            dry[backend] = {"rows": _mesh_rows(dt), "plan": json.dumps(
                {k: p.to_json()[k] for k in ("segments", "knobs", "mesh")},
                sort_keys=True),
                            "n_done": r.n_done, "n": r.n_combinations,
                            "per_mesh_total_s": r.per_mesh_total_s,
                            "sweep_s": time.perf_counter() - t1}
    same = dry["sequential"]["rows"] == dry["process"]["rows"] and \
        dry["sequential"]["plan"] == dry["process"]["plan"]
    if not same:
        fail.append("dry run: process rows or plan differ from in-process")
    for b, d in dry.items():
        if d["n_done"] != d["n"]:
            fail.append(f"dry run {b}: {d['n_done']} of {d['n']} rows done")
    line = {"mesh": "sweep", "arch": cfg.name, "layers": cfg.num_layers,
            "shape": [1, MESH_S, "train"], "points": [
                "local" if m is None else spec.key() for m in points],
            "rows_per_point": _rows_per_point(rows),
            "n_combinations": rep.n_combinations,
            "unique_programs": rep.n_scored,
            "per_mesh_total_s": rep.per_mesh_total_s,
            "plan_mesh": plan.mesh.key() if plan.mesh else None,
            "plan": {s: c.label() for s, c in sorted(plan.segments.items())},
            "sweep_s": wall,
            "dry_run": {b: {"per_mesh_total_s": d["per_mesh_total_s"],
                            "sweep_s": d["sweep_s"], "n_done": d["n_done"]}
                        for b, d in dry.items()},
            "dry_rows_and_plan_identical": same,
            "launches": state["launches"]["mesh sweep granite-8b"],
            "gates_failed": fail}
    print(json.dumps(line), flush=True)
    log(f"mesh sweep: {rep.summary()}; {'ok' if not fail else 'FAIL'}")
    if fail:
        raise SmokeFailure(f"mesh sweep: {fail}")


def _mesh_rows(tuner):
    """Every row of the tuner's project, by (segment, row id), as bytes."""
    return json.dumps(sorted(
        (r["segment"], r["cid"], r["status"], r["cost"])
        for r in tuner.db.results(tuner.project)), sort_keys=True)


def _rows_per_point(rows):
    out = {}
    for seg, cid, status, _ in json.loads(rows):
        point = cid.split("#")[1] if "#" in cid else "unswept"
        out.setdefault(point, {}).setdefault(status, 0)
        out[point][status] += 1
    return out


KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66",
                        ("prefill granite-8b", "prefill recurrentgemma-2b",
                         f"prefill {MOE}", f"prefill {KIMI}",
                         *(f"prefill {a}" for a in DENSE),
                         f"prefill starcoder2-3b S{DENSE_LONG_S}",
                         "train granite-8b", "train recurrentgemma-2b",
                         f"train {MOE}", f"train {DENSE_TRAIN}",
                         "sweep granite-8b", "sweep recurrentgemma-2b",
                         "tune granite-8b", "tune recurrentgemma-2b",
                         "tune lint granite-8b",
                         "backends stablelm-3b sequential",
                         "backends stablelm-3b",
                         "mesh prefill granite-8b tensor_par",
                         "mesh prefill granite-8b fsdp",
                         "mesh train granite-8b", "mesh sweep granite-8b",
                         f"mesh a2a {MOE}")),
    # the reference has no backward kernel: its op's custom_vjp
    # differentiates the plain attention (``_ref``)
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/ops.py:42",
                            ("train granite-8b", f"train {MOE}",
                             f"train {DENSE_TRAIN}", "sweep granite-8b",
                             "tune lint granite-8b",
                             "backends stablelm-3b sequential",
                             "backends stablelm-3b", "mesh train granite-8b",
                             "mesh sweep granite-8b")),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:58",
                     ("serve granite-8b", f"serve {MOE}",
                      *(f"serve {a}" for a in DENSE),
                      "tune granite-8b serving", "tune serve granite-8b",
                      "mesh serve granite-8b", "mesh shardmap granite-8b")),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru.py:46",
              ("prefill recurrentgemma-2b", "train recurrentgemma-2b",
               "sweep recurrentgemma-2b", "tune recurrentgemma-2b")),
    "mlstm": ("src/repro_torch/kernels/csrc/mlstm.cu",
              "src/repro/kernels/mlstm.py:70",
              ("prefill xlstm-125m", "train xlstm-125m",
               "tune xlstm-125m")),
    # no model calls rmsnorm (nor does the reference's): no path
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:18", ()),
}
# the hand-written kernels' symbols, as the profiler names them
PORT_KERNELS = (r"\b(fa_fwd|fa_wgmma|fa_bwd(_prep|_dq)?|fd|rglru|mlstm_\w+|"
                r"rmsnorm)_kernel\b")
NUMBERS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
           "bound_by", "library_ms", "library_device_ms")


def kernels_line(state):
    """The per-kernel JSON line: main-path shape rows + launch counts.

    ``launches`` sums a kernel's launches over the paths this run drove
    (``launches_by_path``).  flash-attention's numbers are at granite-8b's
    prefill shape, and at recurrentgemma-2b's under ``at_head_dim_256``;
    its backward kernel's at granite-8b's train shape (B=2, S=4096).
    """
    rows = state["kernel_checks"]
    paths = state.get("launches", {})

    def pick_row(kernel, **kw):
        for r in rows:
            if r["kernel"] == kernel and all(r.get(k) == v
                                             for k, v in kw.items()):
                return r
        raise SmokeFailure(f"no {kernel} row {kw}")

    def pick(kernel, **kw):
        r = pick_row(kernel, **kw)
        return {k: r[k] for k in NUMBERS}

    main_rows = {
        "flash_attention": pick("flash_attention", dtype="bfloat16", S=2048,
                                window=0, D=128, KV=8),
        "flash_attention_bwd": pick("flash_attention_bwd", S=4096, H=32),
        "flash_decode": pick("flash_decode", dtype="bfloat16", B=1,
                             Smax=2048, pos=63, H=32, KV=8),
        "rglru": pick("rglru", S=2048, decay="model"),
        "mlstm": pick("mlstm", S=2048),
        "rmsnorm": pick("rmsnorm", dtype="bfloat16"),
    }
    out = []
    for name, (src, rep, kpaths) in KERNELS.items():
        by_path = {p: paths[p].get(name, 0) for p in kpaths if p in paths}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, **main_rows[name]}
        if name == "mlstm":
            r = pick_row("mlstm", S=2048)
            entry.update({k: r[k] for k in ("bound_ms_f32", "peak_bytes",
                                             "cuda_kernels_per_call")})
            entry["at_S_4096"] = {k: pick_row("mlstm", S=4096)[k]
                                  for k in NUMBERS + ("peak_bytes",)}
            entry[f"at_train_B{TRAIN_XLSTM_B}_S{TRAIN_XLSTM_S}"] = {
                k: pick_row("mlstm", B=TRAIN_XLSTM_B, S=TRAIN_XLSTM_S)[k]
                for k in NUMBERS + ("peak_bytes",)}
        if name == "rmsnorm":
            r = pick_row("rmsnorm", dtype="bfloat16")
            entry.update(host_ms=r["host_ms"],
                         library_host_ms=r["library_host_ms"])
            entry["at_float32"] = pick("rmsnorm", dtype="float32")
        if name == "flash_decode":
            r = pick_row("flash_decode", dtype="bfloat16", B=1, Smax=2048,
                         pos=63, H=32, KV=8)
            entry.update(host_ms=r["host_ms"],
                         cuda_kernels_per_call=r["cuda_kernels_per_call"])
            for key, kw in (("at_B8_pos4095", dict(B=8, pos=4095, H=32)),
                            ("at_B1_pos4095", dict(B=1, pos=4095, H=32)),
                            ("at_tune_B8_pos1024", dict(B=8, Smax=2048,
                                                        pos=1024, H=32)),
                            ("at_G10_D256", dict(B=1, pos=2047, H=10)),
                            ("at_qwen3_moe", dict(B=1, pos=63, H=32, KV=4)),
                            ("at_kimi_k2_D112", dict(B=1, pos=63, H=64,
                                                     D=112)),
                            ("at_chatglm3_G16", dict(B=1, pos=63, H=32,
                                                     KV=2)),
                            ("at_starcoder2_G12", dict(B=1, pos=63, H=24,
                                                       KV=2)),
                            ("at_phi3_vision_D96", dict(B=1, pos=63, H=32,
                                                        D=96)),
                            ("at_musicgen_D64", dict(B=1, pos=63, H=32,
                                                     D=64))):
                r = pick_row("flash_decode", dtype="bfloat16", **kw)
                entry[key] = {k: r[k] for k in NUMBERS + (
                    "host_ms", "plan", "cuda_kernels_per_call")}
        if name == "flash_attention_bwd":
            extra = ("grad_rel_l2", "lse_max_abs_err",
                     "cuda_kernels_per_call")
            entry.update({k: pick_row("flash_attention_bwd", S=4096,
                                      H=32)[k] for k in extra})
            entry["at_starcoder2_S8192_window4096"] = {
                k: pick_row("flash_attention_bwd", S=8192, H=24)[k]
                for k in NUMBERS + extra}
        if name == "rglru":
            entry["cuda_kernels_per_call"] = pick_row(
                "rglru", S=2048, decay="model")["cuda_kernels_per_call"]
            entry["at_S_4096"] = pick("rglru", S=4096, decay="model")
        if name == "flash_attention":
            # the CUDA kernel's own route at these shapes (bf16: wgmma)
            entry["cuda_route"] = pick_row(
                "flash_attention", dtype="bfloat16", S=2048, window=0,
                D=128, KV=8)["cuda_route"]
            entry["at_head_dim_256"] = pick(
                "flash_attention", dtype="bfloat16", S=2048, window=2048,
                D=256)
            entry["at_head_dim_80"] = pick(
                "flash_attention", dtype="bfloat16", S=2048, window=0, D=80)
            entry["at_train_S_4096"] = pick(
                "flash_attention", dtype="bfloat16", S=4096, window=0,
                D=128)
            entry["at_qwen3_moe"] = pick(
                "flash_attention", dtype="bfloat16", S=2048, window=0,
                D=128, KV=4)
            entry["at_kimi_k2_D112"] = dict(pick(
                "flash_attention", dtype="bfloat16", S=2048, D=112),
                cuda_route=pick_row("flash_attention", dtype="bfloat16",
                                    D=112)["cuda_route"])
            for key, kw in (("at_chatglm3_G16", dict(S=2048, KV=2, H=32)),
                            ("at_starcoder2_S4096", dict(S=4096, H=24)),
                            ("at_starcoder2_S8192_window4096",
                             dict(S=8192, H=24)),
                            ("at_phi3_vision_D96", dict(S=2048, D=96)),
                            ("at_musicgen_D64", dict(S=2048, D=64))):
                r = pick_row("flash_attention", dtype="bfloat16", **kw)
                entry[key] = {k: r[k] for k in NUMBERS + ("cuda_route",
                                                          "cuda_kernels")}
            entry["at_phi3_vision_D96_f32"] = dict(
                pick("flash_attention", dtype="float32", S=2048, D=96),
                cuda_route=pick_row("flash_attention", dtype="float32",
                                    D=96)["cuda_route"])
        out.append(entry)
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 chip_smoke.py")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs "
            "one NVIDIA card")
        return 2
    if not (SRC / "repro_torch").is_dir():
        log(f"FAIL: the port's package is missing ({SRC / 'repro_torch'}); "
            f"run from a checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    # f32 products stay f32 (the kernels' plain versions are the oracle)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    state = {}
    t_all = time.perf_counter()
    runners = {"build": phase_build, "kernels": phase_kernels,
               "prefill": phase_prefill, "serve": phase_serve,
               "trace": phase_trace,
               "prefill-recurrent": phase_prefill_recurrent,
               "serve-recurrent": phase_serve_recurrent,
               "prefill-moe": phase_prefill_moe,
               "serve-moe": phase_serve_moe, "dense": phase_dense,
               "train": phase_train, "sweep": phase_sweep,
               "tune": phase_tune, "backends": phase_backends,
               "mesh": phase_mesh}
    adopt_orphans()
    failed = None
    try:
        for name in PHASES:
            if name in phases:
                t0 = time.perf_counter()
                runners[name](torch, state)
                torch.cuda.synchronize()
                log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    except SmokeFailure as e:
        failed = e
    finally:
        # every process the phases started has stopped before the result
        left = stop_descendants()
    if failed is not None:
        log(f"FAIL: {failed}")
        return 1
    if left:
        log(f"FAIL: processes still running after the phases: {left}")
        return 1
    log(f"all phases: {time.perf_counter() - t_all:.1f}s")
    if "kernels" in phases:
        print(json.dumps(kernels_line(state)))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
