#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Requires CUDA and prints the card's name and power limit, then runs the
phases (each failure exits non-zero and prints no result line):
  build   — compile every CUDA kernel of the serving path from
            ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
            parallel) and print the build time and ptxas statistics.
  kernels — hold each kernel against its plain PyTorch version on the card
            at granite-8b's attention shapes (H 32, KV 8, D 128), f32 and
            bf16, and time kernel, plain version and one PyTorch library
            call (``scaled_dot_product_attention``, a yardstick the port
            never calls) with CUDA events.
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

The last two stdout lines before the final one are the kernels' JSON line
and the ``nvidia-smi`` name/power-limit line; the final line is
``{"ok": true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--phases build,kernels,prefill,serve,trace]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "prefill", "serve", "trace")

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, bf16 tensor-core
# rate, and the f32 rate outside the tensor cores (the kernels' f32 inputs
# keep the reference's exact f32 math).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py floors
# prefill logits, 2 layers at full width, "cuda" vs "plain" plan, bf16
# activations: the two attention paths sum in different orders, so bf16
# roundings of the residual stream may differ by one ulp (2^-8 relative)
PREFILL_ATOL, PREFILL_RTOL = 5e-2, 2e-2


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


def max_err(torch, got, want, dtype: str):
    """(max |got - want|, ok) under atol = rtol = TOL[dtype]."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = TOL[dtype]
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= tol + tol * w.abs()).all())
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
    res = K.build(verbose=True)
    log(f"build: {sorted(res)} in {time.perf_counter() - t0:.1f}s "
        f"(parallel nvcc)")
    for r in res.values():
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {r.name}: {line.strip()}")


def phase_kernels(torch, state):
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    B, H, KV, D = 1, 32, 8, 128
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    failures = []
    rows = state["kernel_checks"] = []

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dt)

    # flash attention: model layout (B,S,H,D), passed head-major as views
    for S, window in ((1000, 0), (2048, 0), (2048, 512)):
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
            if window:
                i = torch.arange(S, device=dev)
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
                lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))
            else:
                lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
            i = torch.arange(S, device=dev)
            live = i[:, None] >= i[None, :]
            if window:
                live &= i[:, None] - i[None, :] < window
            pairs = int(live.sum())        # (q, k) pairs the mask keeps
            item = q.element_size()
            nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * item
            bms, by = bound_ms(nbytes, 4 * B * H * D * pairs, name)
            row = dict(kernel="flash_attention", dtype=name, S=S,
                       window=window, max_abs_err=err, ok=ok, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by)
            rows.append(row)
            log(f"flash_attention {name} S={S} window={window}: "
                f"max_abs_err={err:.3g} ({'ok' if ok else 'FAIL'}) "
                f"kernel={ms:.4f}ms plain={plain:.4f}ms sdpa={lib:.4f}ms "
                f"bound={bms:.4f}ms ({by})")
            if not ok:
                failures.append(f"flash_attention {name} S={S} w={window}")
            del q, k, v, got, want

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
    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: "
                           + ", ".join(failures))


def _plans(cfg):
    from repro_torch.core.plan import uniform_plan
    from repro_torch.models.context import SegmentClause
    return {k: uniform_plan(cfg, "tensor_par", frozenset({"shard_vocab"}),
                            SegmentClause(kernel=k))
            for k in ("cuda", "plain")}


def _params(torch, cfg, state):
    """granite-8b weights from seed 0 on the card, made once per run."""
    if "params" not in state:
        from repro_torch.models.model import model_specs
        from repro_torch.models.params import init_params, param_count
        t0 = time.perf_counter()
        state["params"] = init_params(model_specs(cfg),
                                      torch.Generator().manual_seed(0),
                                      "cuda")
        torch.cuda.synchronize()
        log(f"{cfg.name} params: {param_count(model_specs(cfg)) / 1e9:.3f} "
            f"B, init {time.perf_counter() - t0:.1f}s, allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return state["params"]


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
    state["launches_prefill"] = launches
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
    state["launches_serve"] = launches
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
    """torch.profiler over decode steps of the serving path: three
    admission steps (B=1, scalar pos, flash-decode) and three batched steps
    (B=8, per-row pos).  Reports wall time per step, device-busy share and
    the top operations by device and by host time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_cache
    from repro_torch.serve.step import make_decode_step

    cfg = get_arch("granite-8b")
    params = _params(torch, cfg, state)
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
        log(f"trace {label}: {wall * 1e3:.2f} ms/step wall, device busy "
            f"{busy * 1e3:.2f} ms (idle share {1 - busy / wall:.3f})")
        for a in top_dev:
            log(f"  device {dev(a) / 3e3:8.3f} ms/step  x{a.count // 3:<5d} "
                f"{a.key[:70]}")
        for a in top_cpu:
            log(f"  host   {a.self_cpu_time_total / 3e3:8.3f} ms/step  "
                f"x{a.count // 3:<5d} {a.key[:70]}")
        del caches


def kernels_line(state):
    """The per-kernel JSON line: main-path shape rows + launch counts."""
    rows = state["kernel_checks"]

    def pick(kernel, **kw):
        for r in rows:
            if r["kernel"] == kernel and all(r.get(k) == v
                                             for k, v in kw.items()):
                return r
        raise SmokeFailure(f"no {kernel} row {kw}")

    fa = pick("flash_attention", dtype="bfloat16", S=2048, window=0)
    fd = pick("flash_decode", dtype="bfloat16", B=1, Smax=2048, pos=63)
    out = []
    for name, row, src, rep, n in (
            ("flash_attention", fa,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:66",
             state.get("launches_prefill", {}).get("flash_attention")),
            ("flash_decode", fd,
             "src/repro_torch/kernels/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:58",
             state.get("launches_serve", {}).get("flash_decode"))):
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": n,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
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
    runners = {"build": phase_build, "kernels": phase_kernels,
               "prefill": phase_prefill, "serve": phase_serve,
               "trace": phase_trace}
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
    if "kernels" in phases:
        print(json.dumps(kernels_line(state)))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
