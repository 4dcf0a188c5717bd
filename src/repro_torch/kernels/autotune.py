"""Hierarchical kernel-schedule autotuner (the inner sweep level), as the
reference's ``src/repro/kernels/autotune.py``.

A flat clause sweep pays a whole segment program per (kernel, tile) point:
a T-schedule grid multiplies the outer (provider x flags x clause)
cross-product by T.  This module tunes the kernel ops *in isolation*
instead: it enumerates kernel schedules (``kernel`` in {plain, cuda}
crossed with the ``block_q``/``block_k``/``mlstm_chunk`` grids) per (op,
shape signature, dtype, executor), times each variant as a standalone op
program, and persists the results in the versioned ``kernel_cache`` table
so repeat sweeps time nothing.

The outer engine (``ComParTuner.sweep(kernel_space=..., kernel_top_k=N)``)
then carries only each segment's **top-k surviving schedules** into the
cross-product.

Measurement:

* wall clock (``WallClockExecutor``): the op program on the card (or the
  CPU when the tuner was asked for it), one warm-up call, then the median
  of ``executor.repeats`` calls, each between two CUDA events on a card;
  ``flops = 0``.
* dry run (``DryRunExecutor``): the op program on fake tensors under the
  ``OpCounter``, whose registered flop formulas (``kernels/ops.py``) take
  the place of the reference's HLO count; ``time_s`` is the roofline total
  over ``executor.hw``, ``flops`` the certified floor fed to
  ``combo_lower_bound(kernel_flops=)``.  The bound and the score read the
  same counter, so ``bound <= score`` holds (see ``_measure_one`` for
  flash-decode's position).

The CUDA kernels ignore ``block_q``, ``block_k`` and ``mlstm_chunk``
(``kernels/ops.py``; ROADMAP Queue 1 item 2): every ``cuda`` variant of an
op's grid is one program.  It is run once per (op, shape) and its one
outcome recorded under every ``cuda`` variant key (so ``keeps`` sees the
reference's key set and no noise ranks identical programs); the ``plain``
variants differ by tile and are timed one by one.  A segment's top k
therefore counts programs, not keys (``_top_programs``): its tied ``cuda``
keys survive together beside the next cheapest program, where the
reference's top k keys are k Pallas programs.

Cache key format (the reference's)::

    kernel:v<KERNEL_CACHE_VERSION>:<executor cache_tag>:<op>:<dims>

with one row per (key, canonical variant key).  The executor tag keeps
calibrated, constant-model and measured timings in disjoint rows.
"""
from __future__ import annotations

import gc
import itertools
import logging
import statistics
import time
from typing import Dict, List, Sequence, Tuple

import torch

log = logging.getLogger("repro_torch.autotune")

#: bump on any change to what the microbenchmarks measure or how rows
#: are keyed: stale-version rows are then unreachable (never trusted)
KERNEL_CACHE_VERSION = 1

#: the SegmentClause fields that select each op's schedule, in the order
#: they are keyed.  ``scan_unroll`` shapes the layer loop around the ops,
#: never an op call, so it rides the outer clause space unmeasured.
OP_FIELDS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("kernel", "block_q", "block_k"),
    "flash_decode": ("kernel", "block_k"),
    "mlstm_chunkwise": ("kernel", "mlstm_chunk"),
    "rglru": ("kernel", "mlstm_chunk"),
}

#: default inner grid for ``kernel_space="auto"``: the reference's, with
#: its kernel names mapped (``xla`` -> ``plain``, ``pallas`` -> ``cuda``)
DEFAULT_KERNEL_SPACE: Dict[str, Tuple] = {
    "kernel": ("plain", "cuda"),
    "block_q": (256, 512),
    "block_k": (512, 1024),
    "mlstm_chunk": (128, 256),
}


def schedule_key(fields: Dict[str, object]) -> str:
    """Canonical id of one schedule point (sorted ``k=v`` join): the
    ``kernel_cache`` variant column and the tuner-side projection key."""
    return ",".join(f"{k}={fields[k]}" for k in sorted(fields))


def clause_schedule(clause, fields: Sequence[str]) -> str:
    """Project a SegmentClause onto ``fields`` -> canonical schedule key:
    "which measured variant does this combination use?"."""
    return schedule_key({f: getattr(clause, f) for f in fields})


def segment_ops(cfg, shape, seg) -> Dict[str, int]:
    """op name -> calls in one forward pass of ``seg``.

    Mirrors the models' dispatch sites: attention blocks call
    ``flash_attention`` on full-sequence shapes and ``flash_decode`` on
    decode, except windowed decode, whose ring buffer never reaches the
    kernel (``models/attention.py`` ``attn_decode``).  mLSTM and RG-LRU
    blocks dispatch only on full-sequence shapes (their decode is a
    single-step update); sLSTM has no kernel.
    """
    if seg.kind != "stack":
        return {}
    full_seq = shape.kind in ("train", "prefill")
    counts: Dict[str, int] = {}

    def add(op):
        counts[op] = counts.get(op, 0) + seg.repeats

    for k in seg.pattern:
        if k.startswith("attn"):
            if full_seq:
                add("flash_attention")
            elif shape.kind == "decode" and not cfg.window_size:
                add("flash_decode")
        elif k == "mlstm" and full_seq:
            add("mlstm_chunkwise")
        elif k == "rec" and full_seq:
            add("rglru")
    return counts


def _op_dims(op: str, cfg, shape) -> str:
    """Shape-signature component of the cache key: everything that
    determines the op's input shapes, dtype and masking."""
    B, S = shape.global_batch, shape.seq_len
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if op == "flash_attention":
        return f"B{B}S{S}H{H}KV{KV}D{D}w{cfg.window_size}:{cfg.dtype}"
    if op == "flash_decode":
        return f"B{B}Smax{S}H{H}KV{KV}D{D}:{cfg.dtype}"
    if op == "mlstm_chunkwise":
        di = int(cfg.expand_factor * cfg.d_model)
        return f"B{B}S{S}H{H}dh{di // H}:float32"
    if op == "rglru":
        dr = int(cfg.expand_factor * cfg.d_model)
        return f"B{B}S{S}dr{dr}:float32"
    raise KeyError(op)


def cache_key(op: str, cfg, shape, tag: str) -> str:
    """Versioned ``kernel_cache`` primary key (see module docstring)."""
    return (f"kernel:v{KERNEL_CACHE_VERSION}:{tag}:{op}:"
            f"{_op_dims(op, cfg, shape)}")


# --- isolated op programs ----------------------------------------------------
#
# Each op program is ``(fn, args)``: fn calls the op as the model does
# (same layouts, same clamping), on arguments drawn as the segment
# programs draw theirs (``core/timer.py``).

def _clamp_chunk(chunk: int, S: int) -> int:
    c = min(int(chunk), S)
    while S % c:
        c -= 1
    return c


def _op_program(op: str, fields: Dict[str, object], cfg, shape, device,
                pos=None):
    """``(fn, args)`` of one (op, schedule) variant on ``device`` (on fake
    tensors when built under ``FakeTensorMode``).  ``pos`` is flash-decode's
    position: mid-cache, ``S // 2``, the typical token, unless given."""
    from repro_torch import kernels as kops
    from repro_torch.core.timer import SEED, _materializer
    from repro_torch.models.params import DTYPES

    make = _materializer(torch.device(device), SEED)
    B, S = shape.global_batch, shape.seq_len
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt, f32 = DTYPES[cfg.dtype], torch.float32
    cuda = fields.get("kernel", "plain") == "cuda"

    if op == "flash_attention":
        bq, bk = int(fields["block_q"]), int(fields["block_k"])
        args = (make((B, S, H, D), dt), make((B, S, KV, D), dt),
                make((B, S, KV, D), dt))
        if cuda:
            def fn(q, k, v):
                return kops.flash_attention(q, k, v, causal=True,
                                            window=cfg.window_size,
                                            block_q=bq, block_k=bk)
        else:
            from repro_torch.models.attention import chunked_attention

            def fn(q, k, v):
                p = torch.arange(S, dtype=torch.int32, device=q.device)
                return chunked_attention(q, k, v, pos_q=p, pos_k=p,
                                         window=cfg.window_size, q_chunk=bq)
        return fn, args

    if op == "flash_decode":
        bk = int(fields["block_k"])
        at = S // 2 if pos is None else int(pos)
        args = (make((B, H, D), dt), make((B, S, KV, D), dt),
                make((B, S, KV, D), dt))
        if cuda:
            def fn(q, k, v):
                return kops.flash_decode(q, k, v, at, block_k=bk)
        else:
            from repro_torch.models.attention import decode_attention

            def fn(q, k, v):
                # measured on the bf16-read path: the floor must stay
                # under BOTH cache_upcast settings
                return decode_attention(q, k, v, at, upcast=False)
        return fn, args

    if op == "mlstm_chunkwise":
        dh = int(cfg.expand_factor * cfg.d_model) // H
        args = tuple(make((B, H, S, dh), f32) for _ in range(3)) + \
            tuple(make((B, H, S), f32) for _ in range(2))
        c = _clamp_chunk(fields["mlstm_chunk"], S)
        if cuda:
            def fn(q, k, v, li, lf):
                return kops.mlstm_chunkwise(q, k, v, li, lf, chunk=c)
        else:
            from repro_torch.kernels.ref import mlstm_chunkwise_ref

            def fn(q, k, v, li, lf):
                return mlstm_chunkwise_ref(q, k, v, li, lf, chunk=c)
        return fn, args

    if op == "rglru":
        dr = int(cfg.expand_factor * cfg.d_model)
        args = (make((B, S, dr), f32), make((B, S, dr), f32))
        if cuda:
            return kops.rglru, args
        from repro_torch.kernels.ref import rglru_ref
        return rglru_ref, args

    raise KeyError(op)


# --- measurement -------------------------------------------------------------

def op_variants(op: str, space: Dict[str, Tuple]) -> List[Dict[str, object]]:
    """The variant grid of one op under a (merged) clause space: the
    cross-product of its :data:`OP_FIELDS` values.  Fields absent from
    the space fall back to the SegmentClause default, so every projection
    of an outer-space combination is a measured variant."""
    from repro_torch.models.context import SegmentClause
    default = SegmentClause()
    fields = OP_FIELDS[op]
    values = [tuple(space.get(f) or (getattr(default, f),)) for f in fields]
    return [dict(zip(fields, point))
            for point in itertools.product(*values)]


def _count(op, fields, cfg, shape, pos=None):
    """The OpCounter of one op program run on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.executor import OpCounter
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = _op_program(op, fields, cfg, shape, "cpu", pos=pos)
        with torch.no_grad(), OpCounter() as counter:
            fn(*args)
    return counter


def _wall_times(op, fields, cfg, shape, executor) -> List[float]:
    """Seconds of ``executor.repeats`` calls after one warm-up: CUDA
    events around each call on a card, the wall clock on the CPU."""
    dev = executor.device
    fn, args = _op_program(op, fields, cfg, shape, dev)
    cuda = dev.type == "cuda"
    with torch.no_grad():
        fn(*args)                                   # warm-up
        if cuda:
            torch.cuda.synchronize(dev)
        times, events = [], []
        for _ in range(max(1, int(executor.repeats))):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                events.append((start, end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append(time.perf_counter() - t0)
        if cuda:
            torch.cuda.synchronize(dev)
            times = [s.elapsed_time(e) / 1e3 for s, e in events]
    return times


def _measure_one(op: str, fields: Dict[str, object], cfg, shape,
                 executor) -> Dict[str, object]:
    """Time one (op, schedule) variant in isolation.

    Dry run (the executor has an ``hw`` model): ``time_s`` is the roofline
    total of the op program's counted flops and bytes, ``flops`` the
    certified floor.  The segment programs decode at position 0
    (``core/timer.py``), and flash-decode's kernel counts the keys up to
    its position, so its floor is counted at position 0 (for the plain
    path, which reads the whole cache, the two counts agree).  Wall clock:
    the median of the measured seconds, ``flops=0``.

    A ``cuda`` variant the kernel's wrapper would refuse (the lint's
    ``cuda-*`` errors) fails without running.  Transient failures
    (deadline) return ``status="transient"`` and are never persisted;
    deterministic failures are cached as ``"failed"``.
    """
    from repro_torch.analysis.rules import lint_schedule
    from repro_torch.core.cost_model import terms_from_analysis
    from repro_torch.core.executor import CombinationFailed, deadline
    errs = [d for d in lint_schedule(op, fields, cfg, shape) if d.is_error]
    if errs:
        return {"status": "failed", "error": "static: " +
                "; ".join(f"{d.rule}: {d.message}" for d in errs)}
    hw = getattr(executor, "hw", None)
    try:
        with deadline(getattr(executor, "timeout_s", None)):
            if hw is not None:
                counter = _count(op, fields, cfg, shape)
                flops = counter.flops
                if op == "flash_decode":
                    flops = min(flops, _count(op, fields, cfg, shape,
                                              pos=0).flops)
                terms = terms_from_analysis(counter.flops, counter.bytes,
                                            0.0, 1, hw)
                return {"status": "done", "time_s": terms.total_s,
                        "flops": float(flops)}
            times = _wall_times(op, fields, cfg, shape, executor)
            return {"status": "done", "time_s": statistics.median(times),
                    "flops": 0.0}
    except CombinationFailed as e:
        if e.transient:
            return {"status": "transient", "error": str(e)}
        return {"status": "failed", "error": str(e)}
    except Exception as e:
        return {"status": "failed", "error": f"{type(e).__name__}: {e}"}
    finally:
        if hw is None and executor.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()


def _is_cuda(vkey: str) -> bool:
    return "kernel=cuda" in vkey.split(",")


def measure_op(db, op: str, cfg, shape, space: Dict[str, Tuple],
               executor, use_cache: bool = True
               ) -> Tuple[Dict[str, Dict], int, int]:
    """Measure (or cache-resolve) every variant of one op.

    Returns ``(results, n_timed, n_cached)`` where results maps the
    canonical variant key -> {"status", "time_s", "flops", ...}.  Every
    ``cuda`` variant carries the one outcome of the op's ``cuda`` program
    (run once, or resolved from a cached ``cuda`` row); ``"program"``
    names the variant that was actually run, in the entries measured in
    this call.
    """
    tag = getattr(executor, "cache_tag", "unknown")
    key = cache_key(op, cfg, shape, tag)
    cached = db.kernel_get(key) if (db is not None and use_cache) else {}
    # the op's one cuda outcome: from the cache, or run in this call
    shared = next((e for k, e in sorted(cached.items()) if _is_cuda(k)),
                  None)
    shared_cached = shared is not None
    results: Dict[str, Dict] = {}
    fresh: Dict[str, Dict] = {}
    n_timed = 0
    for fields in op_variants(op, space):
        vkey = schedule_key(fields)
        if vkey in results:
            continue
        hit = cached.get(vkey)
        if hit is None and _is_cuda(vkey) and shared_cached:
            hit = shared
        if hit is not None:
            results[vkey] = dict(hit)
            continue
        if _is_cuda(vkey) and shared is not None:
            entry = dict(shared)            # the program run for this op
        else:
            entry = dict(_measure_one(op, fields, cfg, shape, executor),
                         program=vkey)
            if _is_cuda(vkey) and entry["status"] != "transient":
                shared = entry
        n_timed += 1
        results[vkey] = entry
        if entry["status"] != "transient":    # never persist load-dependent
            fresh[vkey] = entry
    if db is not None and use_cache:
        # cuda variants resolved from a cached cuda row are persisted under
        # their own keys too, so the next lookup finds every key
        for vkey, e in results.items():
            if _is_cuda(vkey) and vkey not in cached and \
                    e["status"] != "transient":
                fresh.setdefault(vkey, e)
        if fresh:
            db.kernel_put_many(key, fresh)
    n_cached = len(results) - n_timed
    return results, n_timed, n_cached


# --- per-segment ranking -----------------------------------------------------

class KernelTuning:
    """The inner sweep's verdict, consumed by the outer engine.

    * ``fields``    segment name -> sorted tuple of tuned clause fields
    * ``surviving`` segment name -> set of top-k schedule keys (over the
      segment's ``fields`` projection); segments with no tuned ops are
      absent: they stay unrestricted.
    * ``floors``    segment name -> {schedule key -> certified isolated
      kernel flops} (dry run only; the wall clock measures no flops)
    * ``report``    the ``SweepReport.kernel_tuning`` observability dict
    * ``variants``  op -> {variant key -> outcome}: every variant's
      status, seconds and, if run in this sweep, the program it ran
    """

    def __init__(self):
        self.fields: Dict[str, Tuple[str, ...]] = {}
        self.surviving: Dict[str, set] = {}
        self.floors: Dict[str, Dict[str, float]] = {}
        self.report: Dict[str, object] = {}
        self.variants: Dict[str, Dict[str, Dict]] = {}

    def keeps(self, seg_name: str, clause) -> bool:
        """Does the outer sweep carry this combination for ``seg_name``?"""
        keep = self.surviving.get(seg_name)
        if keep is None:
            return True
        return clause_schedule(clause, self.fields[seg_name]) in keep

    def floor_flops(self, seg_name: str, clause) -> float:
        """Certified isolated kernel flops for this combination's
        schedule (0.0 when unmeasured: always sound)."""
        table = self.floors.get(seg_name)
        if not table:
            return 0.0
        return table.get(
            clause_schedule(clause, self.fields[seg_name]), 0.0)


def schedule_program(skey: str, ops) -> Tuple[Tuple[str, str], ...]:
    """The programs a segment schedule runs, one per op: all of an op's
    ``cuda`` tile keys are one program (the kernels ignore the tiles),
    each ``plain`` tile key its own."""
    sched = dict(p.split("=", 1) for p in skey.split(","))
    return tuple(
        (op, "cuda" if sched["kernel"] == "cuda" else
         schedule_key({f: sched[f] for f in OP_FIELDS[op]}))
        for op in sorted(ops))


def _top_programs(ranked: List[Tuple[float, str]], ops, top_k: int):
    """Every key of the ``top_k`` cheapest distinct programs, walking
    ``ranked`` in order.  The reference keeps ``top_k`` keys, each its
    own Pallas program; here tied ``cuda`` keys share one program, so
    they survive together and never crowd out the next program."""
    seen, keep = set(), set()
    for _, skey in ranked:
        prog = schedule_program(skey, ops)
        if prog not in seen:
            if len(seen) >= max(1, int(top_k)):
                break
            seen.add(prog)
        keep.add(skey)
    return keep


def tune_segments(db, cfg, shape, segs, space: Dict[str, Tuple],
                  executor, top_k: int = 2,
                  use_cache: bool = True) -> KernelTuning:
    """Run the inner kernel sweep for every segment and rank schedules.

    Per segment: enumerate the schedule grid over the union of its ops'
    tuned fields, score each schedule as ``sum_op(count * time)`` from
    the per-op measurements, keep the ``top_k`` cheapest programs (every
    key of each: ``_top_programs``).  Schedules
    with any failed op variant are excluded (ComPar rejects failed
    combinations); a segment whose schedules ALL failed stays
    unrestricted: degraded, loud, never wrong.
    """
    from repro_torch.models.context import SegmentClause
    out = KernelTuning()
    # measure each distinct op once (segments share op measurements)
    all_ops: Dict[str, int] = {}
    seg_ops: Dict[str, Dict[str, int]] = {}
    for seg in segs:
        ops = segment_ops(cfg, shape, seg)
        seg_ops[seg.name] = ops
        for op in ops:
            all_ops[op] = 1
    measured: Dict[str, Dict[str, Dict]] = {}
    n_timed = n_cached = n_failed = 0
    for op in sorted(all_ops):
        res, t, c = measure_op(db, op, cfg, shape, space, executor,
                               use_cache=use_cache)
        measured[op] = res
        n_timed += t
        n_cached += c
        n_failed += sum(1 for e in res.values() if e["status"] != "done")
    out.variants = measured

    per_op_best = {
        op: min((e["time_s"], k) for k, e in res.items()
                if e["status"] == "done")[1]
        for op, res in measured.items()
        if any(e["status"] == "done" for e in res.values())}

    per_segment: Dict[str, Dict[str, int]] = {}
    has_flops = hasattr(executor, "hw")
    default = SegmentClause()
    for seg in segs:
        ops = seg_ops[seg.name]
        if not ops:
            continue
        fields = tuple(sorted({f for op in ops for f in OP_FIELDS[op]}))
        values = [tuple(space.get(f) or (getattr(default, f),))
                  for f in fields]
        ranked: List[Tuple[float, str]] = []
        floors: Dict[str, float] = {}
        n_sched = 0
        for point in itertools.product(*values):
            sched = dict(zip(fields, point))
            skey = schedule_key(sched)
            n_sched += 1
            cost = flops = 0.0
            ok = True
            for op, count in ops.items():
                vkey = schedule_key(
                    {f: sched[f] for f in OP_FIELDS[op]})
                e = measured[op].get(vkey)
                if e is None or e["status"] != "done":
                    ok = False
                    break
                cost += count * float(e["time_s"])
                flops += count * float(e.get("flops") or 0.0)
            if not ok:
                continue
            ranked.append((cost, skey))
            if has_flops:
                floors[skey] = flops
        if not ranked:
            log.warning("kernel tuning: every schedule of segment %s "
                        "failed; leaving it unrestricted", seg.name)
            per_segment[seg.name] = {"schedules": n_sched, "kept": n_sched}
            continue
        ranked.sort()                       # (cost, key): deterministic ties
        keep = _top_programs(ranked, ops, top_k)
        out.fields[seg.name] = fields
        out.surviving[seg.name] = keep
        if floors:
            out.floors[seg.name] = floors
        per_segment[seg.name] = {"schedules": n_sched, "kept": len(keep)}

    out.report = {
        "n_variants": sum(len(r) for r in measured.values()),
        "n_timed": n_timed,
        "n_cached": n_cached,
        "n_failed": n_failed,
        "top_k": int(top_k),
        "per_op_best": per_op_best,
        "per_segment": per_segment,
    }
    return out
