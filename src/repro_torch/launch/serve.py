"""Serving CLI: continuous-batching greedy decoding under a ComParX plan.

Thin CLI over :class:`repro_torch.serve.engine.ServeEngine`.  The plan is
the ``--plan`` file (a plan fused by either package loads unchanged) or the
built-in default plan.  Runs on the card unless ``--device cpu``.

Usage:
  python -m repro_torch.launch.serve --arch granite-8b
  python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu
  python -m repro_torch.launch.serve --arch recurrentgemma-2b
  python -m repro_torch.launch.serve --arch xlstm-125m --smoke --device cpu
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke \
      --device cpu

``--arch`` takes every arch of ``repro_torch.configs.ARCHS``: granite-8b,
stablelm-3b, recurrentgemma-2b, xlstm-125m, and the MoE archs
qwen3-moe-30b-a3b (57 GiB of bf16 weights: one H100 holds it) and
kimi-k2-1t-a32b (1.03 T parameters: no single card holds it).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Plan, uniform_plan
from repro_torch.models.context import SegmentClause
from repro_torch.serve.engine import Request, ServeEngine


def default_plan(cfg: ArchConfig) -> Plan:
    """The a-priori serving plan, as the reference's ``default_plan`` for
    non-MoE archs at inference shapes: no remat, plain kernels,
    tensor_par[shard_vocab].  MoE archs take it too: the reference's
    expert_par provider for them maps nothing without a mesh."""
    return uniform_plan(cfg, "tensor_par", frozenset({"shard_vocab"}),
                        SegmentClause(remat="none", kernel="plain"))


def synthetic_requests(n: int, vocab: int, *, prompt_len: int,
                       tokens: int, seed: int):
    """Deterministic seeded request stream (varying prompts/lengths)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        p = max(1, prompt_len + int(rng.randint(-1, 2)))
        prompt = tuple(int(t) for t in rng.randint(0, vocab, size=p))
        reqs.append(Request(rid=f"r{i}", prompt=prompt,
                            max_new_tokens=tokens))
    return reqs


def resolve_plan(cfg, *, plan_path=None, registry_db=None):
    """--plan file > default plan."""
    if registry_db:
        raise SystemExit(
            "[serve] --registry-db is not ported yet: the plan registry "
            "comes with the sweep (ROADMAP Queue 1 item 5); pass --plan")
    if plan_path:
        return Plan.load(plan_path), f"file:{plan_path}"
    return default_plan(cfg), "default"


def serve(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    help="granite-8b, stablelm-3b, recurrentgemma-2b, "
                         "xlstm-125m, qwen3-moe-30b-a3b or kimi-k2-1t-a32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="slot capacity (the batch of the decode step)")
    ap.add_argument("--tokens", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--plan", default=None, help="plan JSON file")
    ap.add_argument("--registry-db", default=None,
                    help="not ported yet (comes with the sweep)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--max-active", type=int, default=None,
                    help="admission throttle (1 = sequential baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    plan, src = resolve_plan(cfg, plan_path=args.plan,
                             registry_db=args.registry_db)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"cache={args.cache_len} plan={src} device={args.device}")

    engine = ServeEngine(cfg, plan, capacity=args.batch,
                         cache_len=args.cache_len, seed=args.seed,
                         device=args.device)
    reqs = synthetic_requests(args.requests, cfg.vocab_size,
                              prompt_len=args.prompt_len,
                              tokens=args.tokens, seed=args.seed)
    done = engine.run(reqs, max_active=args.max_active)
    for r in reqs:
        c = done[r.rid]
        print(f"[serve] {r.rid}: prompt={c.prompt_len} "
              f"-> {len(c.tokens)} tokens ({c.finish_reason}) "
              f"{c.tokens[:8]}{'...' if len(c.tokens) > 8 else ''}")
    print(f"[serve] {engine.stats.summary()}")
    return done


if __name__ == "__main__":
    serve()
