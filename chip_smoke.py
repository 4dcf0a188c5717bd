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
            qwen3-moe-30b-a3b's (H 32, KV 4, D 128) and at kimi-k2-1t-a32b's
            (H 64, KV 8, D 112), f32 (the FMA route) and bf16 (the wgmma
            route), with TFLOP/s, against
            ``scaled_dot_product_attention``; flash-decode at granite-8b's
            heads (B=1 at pos 0, 17, 63 and 4095; B=8 at pos 4095), at
            recurrentgemma-2b's (G=10, D=256) and at the two MoE archs'
            heads (B=1, pos 63), with the CUDA
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
            on 8 seeded requests of ~64 prompt tokens and 32 new tokens:
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
            (capacity 8, ``"cuda"`` plan): on 8 seeded requests of ~32
            prompt tokens and 16 new tokens, every request completes and
            the batched streams equal the sequential ones; then a long
            load, 12 requests on the 8 slots, eight of them ~64 prompt
            tokens and 2000 new (past recurrentgemma's 2048-token window):
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
            requests of 12-20 prompt tokens and 16 new: every request
            completes, batched == sequential token for token, flash-decode
            launches == 48 x prompt tokens; then the profile of decode
            steps.
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
            ``launch/train.py`` (B=8, S=512, a "cuda" plan file, remat
            "dots"): 6 steps straight, then 3, a restart from the latest
            checkpoint and 3 more, whose losses must equal the straight
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
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "prefill", "serve", "trace",
          "prefill-recurrent", "serve-recurrent", "prefill-moe", "serve-moe",
          "train", "sweep")
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
# serve-recurrent's long load: 12 requests on 8 slots.  Four short ones
# (~32 prompt tokens, 16 new) free their slots early; eight long ones (~64
# prompt tokens, SERVE_LONG_NEW new) run past recurrentgemma-2b's 2048-token
# window, so its KV ring buffers wrap during batched decode; the last long
# one repeats the first one's prompt in a recycled slot.
SERVE_LONG_NEW = 2000
# decode past the window against the full-sequence forward, f32, one
# rec, rec, attn group at full width: f32 on both sides, so the same 1e-3
# of the logits' std as the xlstm gate, and the rglru kernel's rtol
WRAP_F32_ATOL_PER_STD, WRAP_F32_RTOL = 1e-3, 1e-4
# train: granite-8b at full width cut to 8 layers (full depth with f32
# AdamW state is 99 GB, over one card), at train_4k's sequence, B=1;
# TRAIN_STEPS steps, the first of them the warm-up
TRAIN_GRANITE_LAYERS, TRAIN_GRANITE_S, TRAIN_STEPS = 8, 4096, 4
TRAIN_REC_S = 2048                     # recurrentgemma-2b's first group
# xlstm-125m at full width and depth through launch/train.py
TRAIN_XLSTM_B, TRAIN_XLSTM_S, TRAIN_XLSTM_STEPS = 8, 512, 6
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
# serve-moe: 8 requests of 12-20 prompt tokens and 16 new (each decode
# step reads every expert's weights: ~58 GB, >= 17 ms at 3.35 TB/s)
SERVE_MOE_N, SERVE_MOE_PROMPT, SERVE_MOE_NEW = 8, (12, 20), 16
TRAIN_MOE_LAYERS, TRAIN_MOE_S = 2, 4096
# sweep: the allocated memory a sweep may leave behind, and
# recurrentgemma-2b's prefill sweep (B=1, its prefill-recurrent sequence)
SWEEP_MEMORY_SLACK = 64 * 2**20
SWEEP_REC_S = 2048


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
    from repro_torch.kernels.flash_attention import flash_attention_fwd, route
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
            dev_ms, _ = device_ms(torch, lambda: flash_attention_fwd(
                q, k, v, causal=True, window=window))
            pairs = attention_pairs(S, S, True, window)
            item = q.element_size()
            nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * item
            flops = 4 * B * H * D * pairs
            bms, by = bound_ms(nbytes, flops, name)
            path = route(dt, D)
            rows.append(dict(kernel="flash_attention", dtype=name, S=S, D=D,
                             H=H, KV=KV, window=window, max_abs_err=err,
                             ok=ok, ms=ms, device_ms=dev_ms,
                             plain_ms=plain, library_ms=lib,
                             library_device_ms=lib_dev, bound_ms=bms,
                             bound_by=by, cuda_route=path,
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

    # flash decode at granite-8b's heads (admission is B=1, pos ~63; long
    # caches at B=1 and 8) and at recurrentgemma-2b's (G=10, D=256)
    _fd_checks(torch, rand, rows, failures, H, KV, D,
               ((1, 4096, 0), (1, 4096, 17), (1, 4096, 4095),
                (8, 4096, 4095), (1, 2048, 63)))
    _fd_checks(torch, rand, rows, failures, 10, 1, 256,
               ((1, 2048, 63), (1, 2048, 2047)))
    # admission of qwen3-moe-30b-a3b (G=8) and kimi-k2-1t-a32b (D=112)
    _fd_checks(torch, rand, rows, failures, 32, 4, 128, ((1, 2048, 63),))
    _fd_checks(torch, rand, rows, failures, 64, 8, 112, ((1, 2048, 63),))

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
    # xlstm-125m's train shape (B=8, S=512): the parity check and times
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
    reqs = synthetic_requests(8, cfg.vocab_size, prompt_len=64, tokens=32,
                              seed=0)
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


def _compare_plans(torch, cfg, params, tokens):
    """bf16 logits of the "cuda" and "plain" plans, pointwise."""
    from repro_torch.serve.step import make_prefill
    outs = {k: make_prefill(cfg, plan)(params, {"tokens": tokens})
            for k, plan in _plans(cfg).items()}
    plain = outs["plain"]
    std = float(plain.std())
    atol = PREFILL_REC_ATOL_PER_STD * std
    diff = (outs["cuda"] - plain).abs()
    ok = bool(torch.isfinite(outs["cuda"]).all()) and bool(
        (diff <= atol + PREFILL_RTOL * plain.abs()).all())
    log(f"prefill {cfg.name} {cfg.num_layers} layers cuda vs plain plan: "
        f"max_abs_err={float(diff.max()):.4g} "
        f"mean_abs_err={float(diff.mean()):.3g}, logits std {std:.4g} "
        f"(atol {atol:.4g} = {PREFILL_REC_ATOL_PER_STD} std, rtol "
        f"{PREFILL_RTOL}) {'ok' if ok else 'FAIL'}")
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
        reqs = synthetic_requests(8, cfg.vocab_size, prompt_len=32,
                                  tokens=16, seed=0)
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
        _serve_long(torch, cfg, eng)
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


def _serve_long(torch, cfg, eng):
    """The long load (see SERVE_LONG_NEW): tok/s and peak memory, every
    request complete, and the repeated request's stream equal to the
    first's although it ran in another slot, admitted later."""
    from repro_torch.launch.serve import synthetic_requests
    long = [dataclasses.replace(r, rid=f"long{i}") for i, r in enumerate(
        synthetic_requests(7, cfg.vocab_size, prompt_len=64,
                           tokens=SERVE_LONG_NEW, seed=1))]
    short = [dataclasses.replace(r, rid=f"short{i}") for i, r in enumerate(
        synthetic_requests(4, cfg.vocab_size, prompt_len=32, tokens=16,
                           seed=2))]
    again = dataclasses.replace(long[0], rid="long0-again")
    reqs = long[:4] + short + long[4:] + [again]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    st, peak = eng.stats, torch.cuda.max_memory_allocated()
    longest = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    log(f"serve {cfg.name} long load: {st.summary()}")
    log(f"serve {cfg.name} long load: {len(reqs)} requests on "
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
    """Each MoE layer's routing through ``models.moe.route``, in call
    order: ``"record"`` appends every call's expert ids to ``store``;
    ``"replay"`` makes every call take ``store``'s ids in turn (gates from
    this run's probabilities at those experts, normalized as the router
    does), so that two plans route alike and differ only by their
    kernels."""
    from repro_torch.models import moe
    route = moe.route
    replay = iter(store) if mode == "replay" else None

    def wrapped(router, xf, k):
        probs, gates, idx = route(router, xf, k)
        if mode == "record":
            store.append(idx.clone())
        elif mode == "replay":
            idx = next(replay)
            gates = probs.gather(-1, idx)
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return probs, gates, idx
    moe.route = wrapped
    try:
        yield store
    finally:
        moe.route = route


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


def _prefill_once(torch, cfg, params, tokens, label, want_fa):
    """``make_prefill`` under the "cuda" plan (after a warm-up): wall ms,
    peak memory, finite logits of the right shape and exactly ``want_fa``
    flash-attention launches (and no other kernel)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.step import make_prefill
    prefill = make_prefill(cfg, _plans(cfg)["cuda"])
    prefill(params, {"tokens": tokens[:, :128]})        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    S = tokens.shape[1]
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
    operations."""
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


def _compare_f32(torch, cfg, params, tokens, label):
    """The same in f32 on a cast copy, pointwise without replay (see
    MOE_F32_ATOL_PER_STD); the routing agreement is read beside it."""
    from repro_torch.models.params import tree_map
    from repro_torch.serve.step import make_prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    routes = {}
    outs = {}
    for k, plan in _plans(cfg32).items():
        with _routes("record", routes.setdefault(k, [])):
            outs[k] = make_prefill(cfg32, plan)(p32, {"tokens": tokens})
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


def _moe_requests(cfg):
    """SERVE_MOE_N seeded requests of SERVE_MOE_PROMPT prompt tokens."""
    import numpy as np

    from repro_torch.serve.engine import Request
    rng = np.random.RandomState(0)
    lo, hi = SERVE_MOE_PROMPT
    return [Request(rid=f"r{i}", prompt=tuple(int(t) for t in rng.randint(
        0, cfg.vocab_size, int(rng.randint(lo, hi + 1)))),
        max_new_tokens=SERVE_MOE_NEW) for i in range(SERVE_MOE_N)]


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
    reqs = _moe_requests(cfg)
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
    reads 1.0) under ``bound``, and every leaf's grad norm > 0.  For an
    MoE arch the cuda plan's run replays the plain plan's routing (see
    MOE_AGREE_MIN)."""
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
    worst, bad, rows = 0.0, [], []
    for path, g, w in zip(paths, tree_leaves(out["cuda"][1]),
                          tree_leaves(out["plain"][1])):
        norm = float(g.float().norm())
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
    # (the backward is autograd of the plain f32 attention), the head's
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
    a = _sweep_quickstart(torch, state)
    _sweep_recurrentgemma(torch, state)
    _sweep_dry_run(torch, state, a)


def _programs(tuner):
    """One row per unique program (segment, clause) of a sweep: its
    status, median ms, peak GiB and error."""
    out = {}
    for r in tuner.db.results(tuner.project):
        cl = r["combo"].clause
        key = f"{r['segment']}/{cl.remat}/{cl.kernel}"
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
def _launches_per_job():
    """Each wall-clock job's kernel launches (its warm-up and timed calls),
    keyed ``segment/remat/kernel``: every job of a sweep run inside."""
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
            per_job[f"{seg.name}/{cl.remat}/{cl.kernel}"] = {
                k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
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
    whose backward reruns the forward), and nothing else."""
    calls = 1 + tuner.executor.repeats         # the warm-up and the timed
    groups = cfg.stack_plan()
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


# kernel -> (source, TPU kernel it replaces, the paths that launch it)
KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66",
                        ("prefill granite-8b", "prefill recurrentgemma-2b",
                         f"prefill {MOE}", f"prefill {KIMI}",
                         "train granite-8b", "train recurrentgemma-2b",
                         f"train {MOE}",
                         "sweep granite-8b", "sweep recurrentgemma-2b")),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:58",
                     ("serve granite-8b", f"serve {MOE}")),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru.py:46",
              ("prefill recurrentgemma-2b", "train recurrentgemma-2b",
               "sweep recurrentgemma-2b")),
    "mlstm": ("src/repro_torch/kernels/csrc/mlstm.cu",
              "src/repro/kernels/mlstm.py:70",
              ("prefill xlstm-125m", "train xlstm-125m")),
    # no model calls rmsnorm (nor does the reference's): no path
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:18", ()),
}
# the hand-written kernels' symbols, as the profiler names them
PORT_KERNELS = r"\b(fa_fwd|fa_wgmma|fd|rglru|mlstm_\w+|rmsnorm)_kernel\b"
NUMBERS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
           "bound_by", "library_ms", "library_device_ms")


def kernels_line(state):
    """The per-kernel JSON line: main-path shape rows + launch counts.

    ``launches`` sums a kernel's launches over the paths this run drove
    (``launches_by_path``).  flash-attention's numbers are at granite-8b's
    prefill shape, and at recurrentgemma-2b's under ``at_head_dim_256``.
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
            entry["at_train_B8_S512"] = {
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
                            ("at_G10_D256", dict(B=1, pos=2047, H=10)),
                            ("at_qwen3_moe", dict(B=1, pos=63, H=32, KV=4)),
                            ("at_kimi_k2_D112", dict(B=1, pos=63, H=64,
                                                     D=112))):
                r = pick_row("flash_decode", dtype="bfloat16", **kw)
                entry[key] = {k: r[k] for k in NUMBERS + (
                    "host_ms", "plan", "cuda_kernels_per_call")}
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
               "serve-moe": phase_serve_moe,
               "train": phase_train, "sweep": phase_sweep}
    try:
        for name in PHASES:
            if name in phases:
                t0 = time.perf_counter()
                runners[name](torch, state)
                torch.cuda.synchronize()
                log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    except SmokeFailure as e:
        log(f"FAIL: {e}")
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
