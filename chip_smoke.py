#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Requires CUDA and prints the card's name and power limit, then runs the
phases (each failure exits non-zero and prints no result line):
  build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
            (one nvcc per source, in parallel) and print the build time and
            ptxas statistics.
  kernels — hold each kernel against its plain PyTorch version on the card
            at its path's shapes, and time kernel, plain version and, where
            one PyTorch call computes the same function, that call (a
            yardstick the port never calls) with CUDA events:
            flash-attention at granite-8b's heads (H 32, KV 8, D 128) and at
            recurrentgemma-2b's (H 10, KV 1, D 256, window 2048, also at
            S=4096 > window), f32 and bf16, against
            ``scaled_dot_product_attention``; flash-decode at granite-8b's;
            rglru at (1, 2048, 2560) and an odd S; mlstm at (1, 4, 2048,
            384) against the chunkwise plain version at three chunks and the
            step-recurrent oracle; rmsnorm at (2048, 2560), f32 and bf16,
            against ``F.rms_norm``.
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

Every path is driven with the launch counts set to 0 just before it and
read just after.  The last two stdout lines before the final one are the
kernels' JSON line and the ``nvidia-smi`` name/power-limit line; the final
line is ``{"ok": true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--phases build,kernels,...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "prefill", "serve", "trace",
          "prefill-recurrent", "serve-recurrent")
RECURRENT = ("recurrentgemma-2b", "xlstm-125m")

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, bf16 tensor-core
# rate, and the f32 rate outside the tensor cores (the kernels' f32 inputs
# keep the reference's exact f32 math).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

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
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {r.name}: {line.strip()}")


def _fa_checks(torch, rand, rows, failures, H, KV, D, cases):
    """flash-attention against its plain version at (H, KV, D) for each
    (S, window) of ``cases``, f32 and bf16; kernel, plain and SDPA times."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_fwd

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
                lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=live, enable_gqa=True))
            else:
                lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
            pairs = int(live.sum())        # (q, k) pairs the mask keeps
            item = q.element_size()
            nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * item
            bms, by = bound_ms(nbytes, 4 * B * H * D * pairs, name)
            rows.append(dict(kernel="flash_attention", dtype=name, S=S, D=D,
                             H=H, KV=KV, window=window, max_abs_err=err,
                             ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bms, bound_by=by))
            log(f"flash_attention {name} H={H} KV={KV} D={D} S={S} "
                f"window={window}: max_abs_err={err:.3g} "
                f"({'ok' if ok else 'FAIL'}) kernel={ms:.4f}ms "
                f"plain={plain:.4f}ms sdpa={lib:.4f}ms bound={bms:.4f}ms "
                f"({by})")
            if not ok:
                failures.append(f"flash_attention {name} D={D} S={S} "
                                f"w={window}")
            del q, k, v, got, want, live


def phase_kernels(torch, state):
    import torch.nn.functional as F

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

    # granite-8b's heads; recurrentgemma-2b's (MQA, D=256, its window 2048
    # at S=2048 and at S=4096 > window)
    _fa_checks(torch, rand, rows, failures, H, KV, D,
               ((1000, 0), (2048, 0), (2048, 512)))
    _fa_checks(torch, rand, rows, failures, 10, 1, 256,
               ((2048, 2048), (4096, 2048)))

    # flash decode: caches (B,Smax,KV,D), passed head-major as views
    for Bd, Smax, pos in ((1, 4096, 0), (1, 4096, 17), (1, 4096, 4095),
                          (8, 4096, 4095), (1, 2048, 63)):
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
            ms = cuda_ms(torch, lambda: flash_decode_fwd(q, kh, vh, pos),
                         reps=50)
            plain = cuda_ms(torch, lambda: R.flash_decode_ref(q, kc, vc,
                                                              pos), reps=10)
            n = pos + 1
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kh[:, :, :n], vh[:, :, :n], enable_gqa=True),
                reps=50)
            item = q.element_size()
            nbytes = (2 * Bd * H * D + 2 * Bd * n * KV * D) * item
            bms, by = bound_ms(nbytes, 4 * Bd * H * D * n, name)
            row = dict(kernel="flash_decode", dtype=name, B=Bd, Smax=Smax,
                       pos=pos, max_abs_err=err, lse_max_abs_err=lerr,
                       ok=ok and lok, ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=bms, bound_by=by)
            rows.append(row)
            log(f"flash_decode {name} B={Bd} Smax={Smax} pos={pos}: "
                f"max_abs_err={err:.3g} lse_err={lerr:.3g} "
                f"({'ok' if ok and lok else 'FAIL'}) kernel={ms:.4f}ms "
                f"plain={plain:.4f}ms sdpa={lib:.4f}ms bound={bms:.4f}ms "
                f"({by})")
            if not (ok and lok):
                failures.append(f"flash_decode {name} B={Bd} pos={pos}")

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
    # (-10.6, 0); recurrentgemma's dr = 2560; an odd S too
    for S in (2048, 2047):
        la = -8.0 * math.log1p(math.e) * torch.sigmoid(
            rand((1, S, 2560), f32))
        b = rand((1, S, 2560), f32)
        got = rglru_fwd(la, b)
        err, ok = max_err(torch, got, R.rglru_ref(la, b), "float32",
                          RGLRU_TOL)
        row = dict(kernel="rglru", S=S, max_abs_err=err, ok=ok)
        extra = ""
        if S == 2048:
            n = la.numel()
            bms, by = bound_ms(3 * 4 * n, 3 * n, "float32")
            row.update(ms=cuda_ms(torch, lambda: rglru_fwd(la, b), reps=50),
                       plain_ms=cuda_ms(torch, lambda: R.rglru_ref(la, b)),
                       library_ms=None, bound_ms=bms, bound_by=by)
            extra = (f" kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}"
                     f"ms library=none bound={bms:.4f}ms ({by})")
        rows.append(row)
        report("rglru", f"(1, {S}, 2560) f32", err, ok, extra)

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
            main = dict(kernel="mlstm", max_abs_err=err, ok=ok)
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
    flops = 0
    for t0 in range(0, S, c):       # the kernel's chunks of this S
        cl = min(c, S - t0)
        flops += 4 * cl * cl * dh + 2 * cl * dh * dh
        if t0 + c < S:              # no state update after the last chunk
            flops += 2 * cl * dh * dh
    bms, by = bound_ms(4 * (4 * B * H * S * dh + 2 * B * H * S),
                       B * H * flops, "float32")
    main.update(ms=cuda_ms(torch, lambda: mlstm_fwd(q, k, v, li, lf)),
                plain_ms=cuda_ms(torch, lambda: R.mlstm_chunkwise_ref(
                    q, k, v, li, lf, chunk=256), reps=5),
                library_ms=None, bound_ms=bms, bound_by=by, chunk=c)
    rows.append(main)
    log(f"mlstm (1, 4, 2048, 384): kernel={main['ms']:.4f}ms "
        f"plain={main['plain_ms']:.4f}ms library=none bound={bms:.4f}ms "
        f"({by}, kernel chunk {c})")
    del q, k, v, li, lf, got

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
        row = dict(kernel="rmsnorm", dtype=name, N=N, d=d, max_abs_err=err,
                   ok=ok, ms=cuda_ms(torch, lambda: rmsnorm_fwd(x, scale),
                                     reps=50),
                   plain_ms=cuda_ms(torch, lambda: R.rmsnorm_ref(x, scale)),
                   library_ms=cuda_ms(torch, lambda: F.rms_norm(
                       x, (d,), weight=scale, eps=1e-6), reps=50),
                   bound_ms=bms, bound_by=by)
        rows.append(row)
        report("rmsnorm", f"({N}, {d}) {name}", err, ok,
               f" kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}ms "
               f"rms_norm={row['library_ms']:.4f}ms bound={bms:.4f}ms "
               f"({by})")


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

        def dev(a):
            return getattr(a, "self_device_time_total",
                           getattr(a, "self_cuda_time_total", 0.0))
        busy = sum(dev(a) for a in avgs) / 3 / 1e6     # us -> s per step
        top_dev = sorted(avgs, key=dev, reverse=True)[:8]
        top_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                         reverse=True)[:8]
        log(f"trace {cfg.name} {label}: {wall * 1e3:.2f} ms/step wall, "
            f"device busy {busy * 1e3:.2f} ms (idle share "
            f"{1 - busy / wall:.3f})")
        for a in top_dev:
            log(f"  device {dev(a) / 3e3:8.3f} ms/step  x{a.count // 3:<5d} "
                f"{a.key[:70]}")
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


# kernel -> (source, TPU kernel it replaces, the paths that launch it)
KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66",
                        ("prefill granite-8b", "prefill recurrentgemma-2b")),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:58",
                     ("serve granite-8b",)),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru.py:46",
              ("prefill recurrentgemma-2b",)),
    "mlstm": ("src/repro_torch/kernels/csrc/mlstm.cu",
              "src/repro/kernels/mlstm.py:70", ("prefill xlstm-125m",)),
    # no model calls rmsnorm (nor does the reference's): no path
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:18", ()),
}
NUMBERS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
           "library_ms")


def kernels_line(state):
    """The per-kernel JSON line: main-path shape rows + launch counts.

    ``launches`` sums a kernel's launches over the paths this run drove
    (``launches_by_path``).  flash-attention's numbers are at granite-8b's
    prefill shape, and at recurrentgemma-2b's under ``at_head_dim_256``.
    """
    rows = state["kernel_checks"]
    paths = state.get("launches", {})

    def pick(kernel, **kw):
        for r in rows:
            if r["kernel"] == kernel and all(r.get(k) == v
                                             for k, v in kw.items()):
                return {k: r[k] for k in NUMBERS}
        raise SmokeFailure(f"no {kernel} row {kw}")

    main_rows = {
        "flash_attention": pick("flash_attention", dtype="bfloat16", S=2048,
                                window=0, D=128),
        "flash_decode": pick("flash_decode", dtype="bfloat16", B=1,
                             Smax=2048, pos=63),
        "rglru": pick("rglru", S=2048),
        "mlstm": pick("mlstm"),
        "rmsnorm": pick("rmsnorm", dtype="bfloat16"),
    }
    out = []
    for name, (src, rep, kpaths) in KERNELS.items():
        by_path = {p: paths[p].get(name, 0) for p in kpaths if p in paths}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, **main_rows[name]}
        if name == "flash_attention":
            entry["at_head_dim_256"] = pick(
                "flash_attention", dtype="bfloat16", S=2048, window=2048,
                D=256)
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
               "serve-recurrent": phase_serve_recurrent}
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
