"""Multi-pod dry run: every (arch x shape x mesh) cell's step on fake tensors
over the production mesh, the reference's ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell with ``jax.jit`` on the
(16, 16) and (2, 16, 16) meshes of a host that fakes 512 devices
(``--xla_force_host_platform_device_count``): the proof that the
distribution config holds together without the hardware, and the source
of the roofline terms.  Here a cell's train step, prefill or decode step
(the step factories a user calls) runs once on fake tensors
(``FakeTensorMode``: no data, no device memory) laid out on a
``DeviceMesh`` over a fake process group (``launch.mesh.fake_group``: 256
or 512 ranks, whose collectives move nothing), under
``core.executor.OpCounter``: the per-device flops, bytes and collective
bytes (``runtime.hlo``) over the H100's rates.

Named departure: the reference's ``memory_analysis`` (XLA's buffer
assignment) becomes the argument bytes (each rank's local shards of the
params, optimizer state, caches and batch) plus the peak of the bytes the
step allocates while they live, as the counter tracks them.

Results are written incrementally to a JSON file; finished cells are
skipped on a restart (Continue mode), and a failed cell makes the exit
code 1.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.json]
  python -m repro_torch.launch.dryrun --device cpu --arch granite-8b \\
      --smoke --shape decode_32k
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, \
    shape_applies
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.combinator import GlobalKnobs
from repro_torch.core.cost_model import H100, CostTerms, Hardware
from repro_torch.core.plan import Plan, uniform_plan
from repro_torch.models.context import SegmentClause

#: the production meshes (data x model; pod x data x model), and the
#: smoke configs' stand-ins: a model axis of 4, so a smoke config's 2 kv
#: heads do not divide it and its KV cache is split along the sequence
MESHES = {(False, False): ((16, 16), ("data", "model")),
          (True, False): ((2, 16, 16), ("pod", "data", "model")),
          (False, True): ((1, 4), ("data", "model")),
          (True, True): ((2, 1, 4), ("pod", "data", "model"))}

_MOE_FLAGS = frozenset({"tp_attention", "fsdp_dense", "2d_experts"})


def default_plan(cfg: ArchConfig, shape: ShapeConfig) -> Plan:
    """The a-priori 'single best compiler' baseline plan per cell (what a
    practitioner would pick without ComParX's sweep), the reference's,
    with the port's kernel name (``"plain"`` for the reference's
    ``"xla"``).  ``launch/train.py`` and ``launch/serve.py`` start from
    it."""
    if shape.kind == "train":
        clause = SegmentClause(remat="dots", kernel="plain")
        knobs = GlobalKnobs(microbatches=1, donate=True,
                            opt_state_dtype="bfloat16" if cfg.is_moe
                            else "float32")
        if cfg.is_moe:
            return uniform_plan(cfg, "expert_par", _MOE_FLAGS, clause, knobs)
        return uniform_plan(cfg, "hybrid2d", frozenset({"shard_vocab"}),
                            clause, knobs)
    clause = SegmentClause(remat="none", kernel="plain")
    if cfg.is_moe:
        return uniform_plan(cfg, "expert_par", _MOE_FLAGS, clause)
    return uniform_plan(cfg, "tensor_par", frozenset({"shard_vocab"}),
                        clause)


def _config(arch: str, shape_name: Optional[str], smoke: bool):
    cfg = get_arch(arch)
    shape = get_shape(shape_name or "train_4k")
    return (cfg.smoke(), shape.smoke()) if smoke else (cfg, shape)


def input_specs(arch: str, shape_name: Optional[str] = None, *,
                smoke: bool = False) -> Dict:
    """``TensorSpec`` stand-ins for every model input of a cell."""
    cfg, shape = _config(arch, shape_name, smoke)
    if shape.kind == "train":
        from repro_torch.train.step import batch_specs
        return {"batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        from repro_torch.serve.step import prefill_input_specs
        return {"batch": prefill_input_specs(cfg, shape)}
    from repro_torch.serve.step import decode_input_specs
    return decode_input_specs(cfg, shape)


def cell_mesh(multi_pod: bool = False, smoke: bool = False,
              device: str = "cpu"):
    """The cell's mesh on the default group (a fake one in the dry run)."""
    from repro_torch.launch.mesh import device_mesh, make_production_mesh
    if not smoke:
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    shape, axes = MESHES[(multi_pod, True)]
    return device_mesh(shape, axes, device)


def _local_bytes(tree) -> int:
    """Bytes of each rank's local shards of a tree of tensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    n = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               plan: Optional[Plan] = None, device: str = "cpu"):
    """Build one cell's step and run it once on fake tensors laid out on
    ``mesh``, under an ``OpCounter``.  Returns ``(counter, memory)``:
    ``memory`` has the argument, output and temporary (peak live) bytes
    per device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.executor import OpCounter
    from repro_torch.models.model import cache_specs, model_specs
    from repro_torch.models.params import (abstract_params, fake_tensors,
                                           place_params)
    from repro_torch.core.plan import segment_rules
    from repro_torch.serve.step import (decode_input_specs, make_decode_step,
                                        make_prefill, place_caches,
                                        prefill_input_specs)
    from repro_torch.train.step import (abstract_train_state, batch_specs,
                                        init_train_state, make_train_step,
                                        place_batch)
    plan = plan or default_plan(cfg, shape)
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            step = make_train_step(cfg, plan, device=device, mesh=mesh)
            params, _ = abstract_train_state(cfg, plan)
            params, opt = init_train_state(
                cfg, plan, None, device, mesh=mesh,
                params=fake_tensors(params, device))
            batch = place_batch(fake_tensors(batch_specs(cfg, shape),
                                             device), cfg, plan, mesh)
            args = (params, opt, batch)
            run = step
        else:
            specs = model_specs(cfg)
            params = place_params(
                fake_tensors(abstract_params(specs), device), specs,
                segment_rules(cfg, plan, mesh))
            if shape.kind == "prefill":
                run = make_prefill(cfg, plan, device=device, mesh=mesh,
                                   gather=False)
                batch = place_batch(fake_tensors(
                    prefill_input_specs(cfg, shape), device), cfg, plan,
                    mesh)
                args = (params, batch)
            else:
                run = make_decode_step(cfg, plan, device=device, mesh=mesh,
                                       gather=False)
                caches = place_caches(fake_tensors(
                    cache_specs(cfg, shape.global_batch, shape.seq_len),
                    device), cfg, plan, mesh)
                tokens = fake_tensors(decode_input_specs(cfg, shape),
                                      device)["tokens"]
                # every position of the cache attended
                args = (params, caches, tokens, shape.seq_len - 1)
        arg_bytes = _local_bytes(args)
        with OpCounter() as counter:
            out = run(*args)
        memory = {"argument_bytes": arg_bytes,
                  "output_bytes": _local_bytes(out),
                  "temp_bytes": counter.peak_live,
                  "peak_bytes": arg_bytes + counter.peak_live}
    return counter, memory


def analyze_cell(counter, memory: Dict, n_chips: int,
                 hw: Hardware = H100) -> CostTerms:
    """The roofline terms of a counted cell, the reference's
    ``analyze_compiled``: the counts are one device's."""
    res = counter.analysis()
    f, b, c = res["flops"], res["bytes"], res["collective"]
    terms = CostTerms(compute_s=f / hw.peak_flops, memory_s=b / hw.hbm_bw,
                      collective_s=c / hw.link_bw, flops=f * n_chips,
                      bytes_accessed=b * n_chips, collective_bytes=c,
                      bytes_per_device=memory["peak_bytes"])
    terms.detail.update({k: v for k, v in res.items()
                         if k.startswith("coll_")})
    terms.detail.update(memory)
    return terms


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             plan: Optional[Plan] = None, timeout_s: int = 1800,
             verbose: bool = True, device: str = "cpu",
             smoke: bool = False) -> Dict:
    from repro_torch.core.executor import deadline
    from repro_torch.launch.mesh import mesh_chips
    cfg, shape = _config(arch, shape_name, smoke)
    where = "multi" if multi_pod else "single"
    if not shape_applies(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": where,
                "status": "skip",
                "reason": "full-attention arch; long_500k needs "
                          "sub-quadratic attention (DESIGN.md)"}
    t0 = time.time()
    try:
        with deadline(timeout_s):
            mesh = cell_mesh(multi_pod, smoke, device)
            counter, memory = lower_cell(cfg, shape, mesh, plan, device)
            terms = analyze_cell(counter, memory, mesh_chips(mesh))
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": where,
                "status": "fail", "elapsed_s": time.time() - t0,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    rec = {"arch": arch, "shape": shape_name, "mesh": where,
           "chips": mesh_chips(mesh), "status": "ok",
           "elapsed_s": round(time.time() - t0, 1),
           "cost": terms.as_dict(), "detail": terms.detail,
           "dominant": terms.dominant}
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} "
              f"({'x'.join(map(str, mesh.shape))}): "
              f"compute={terms.compute_s:.4f}s memory={terms.memory_s:.4f}s "
              f"collective={terms.collective_s:.4f}s "
              f"dominant={terms.dominant} "
              f"bytes/dev={terms.bytes_per_device / 2**30:.2f}GiB "
              f"[{rec['elapsed_s']}s]", flush=True)
        print(f"  memory: {json.dumps(memory)}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None,
                    help="an arch of repro_torch.configs.ARCHS (default: "
                         "all)")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--plan", default=None,
                    help="path to a Plan json (default: per-cell baseline)")
    ap.add_argument("--device", default="cuda",
                    help="the device type the fake tensors stand on "
                         "(cuda or cpu; no memory is used on it)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs and shapes on the smoke meshes "
                         "(1, 4) and (2, 1, 4)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import fake_group, world_size
    device = resolve_device(args.device).type

    plan = Plan.load(args.plan) if args.plan else None
    results = {}
    if os.path.exists(args.out):          # Continue mode
        with open(args.out) as f:
            results = json.load(f)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    # one fake group for every cell (the largest mesh's ranks), unless
    # the caller holds a group already
    need = max(math.prod(MESHES[(mp, args.smoke)][0]) for _, _, mp in cells)
    group = fake_group(need) if world_size() is None \
        else contextlib.nullcontext()
    with group:
        for a, s, mp in cells:
            key = f"{a}|{s}|{'multi' if mp else 'single'}"
            if key in results and \
                    results[key].get("status") in ("ok", "skip"):
                print(f"[dryrun] {key}: cached ({results[key]['status']})")
                continue
            results[key] = run_cell(a, s, multi_pod=mp, plan=plan,
                                    timeout_s=args.timeout, device=device,
                                    smoke=args.smoke)
            with open(args.out, "w") as f:      # incremental commit
                json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skip")
    n_fail = sum(1 for r in results.values() if r["status"] == "fail")
    print(f"[dryrun] done: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        for k, r in results.items():
            if r["status"] == "fail":
                print(f"  FAIL {k}: {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
