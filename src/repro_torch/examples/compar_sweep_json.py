"""ComPar-style JSON-driven sweep (the paper's three-JSON input) with DB
Continue mode, the port's counterpart of the reference's
``examples/compar_sweep_json.py``: run once, run again, and the finished
combinations are not run again.

The ``"globals"`` field is the paper's RTL-routine axis: a GlobalKnobs
grid swept as an outer dimension of the same sweep, with the fused
plan's knobs chosen by the joint argmin.

With ``--remote-url`` the scoring leaves this process: jobs are shipped to
a sweep scoring server (``python -m repro_torch.core.backends.server --db
scores.db``) and resolved against ITS score cache first.

    python -m repro_torch.examples.compar_sweep_json        # the card
    python -m repro_torch.examples.compar_sweep_json --smoke --device cpu
        [--backend B] [--remote-url http://host:8477] [--remote-token S]

With ``--smoke`` it is the reference's example: stablelm-3b's smoke config
at train_4k's smoke shape, scored by the dry run.  Without it, it runs on
the card: stablelm-3b at full width cut to ``--layers`` layers, B=2 at
S=2048 (4096 tokens a step; at B=1 the spec's microbatches=2 point cannot
split the batch), the wall-clock executor, and the same spec with
``kernel`` in {plain, cuda} added to its clauses.  ``--mesh-space`` adds
the JSON ``"meshes"`` topology axis: the local point against the flat data
ring of the default process group (one rank without a group: a
world-size-1 group is made, and destroyed at the end).  The reference
races a 2-way data ring on 2 local devices; a process here holds one
device, so a 2-way ring needs a 2-rank group.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.combinator import load_sweep_json
from repro_torch.core.db import SweepDB
from repro_torch.core.tuner import ComParTuner
from repro_torch.device import resolve_device

SWEEP_SPEC = {
    # which "compilers" to consider, with the flags the user trusts
    "providers": {"tensor_par": ["shard_vocab"], "fsdp": []},
    # OpenMP directive-clause analogue
    "clauses": {"remat": ["none", "dots"], "block_q": [16]},
    # RTL-routine analogue: swept as the outer knob axis
    "globals": {"microbatches": [1, 2]},
}


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.compar_sweep_json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference example's smoke config, dry run")
    ap.add_argument("--layers", type=int, default=8,
                    help="stablelm-3b's depth, cut (without --smoke)")
    ap.add_argument("--backend", default="thread",
                    choices=("thread", "sequential", "process", "remote"))
    ap.add_argument("--remote-url", dest="remote_url", default=None,
                    help="sweep scoring server URL (python -m "
                         "repro_torch.core.backends.server); implies "
                         "--backend remote")
    ap.add_argument("--remote-token", dest="remote_token", default=None,
                    help="shared-secret auth token for a --token scoring "
                         "server (sent as Authorization: Bearer)")
    ap.add_argument("--mesh-space", dest="mesh_space", action="store_true",
                    help="also sweep the JSON 'meshes' topology axis "
                         "(local vs the default group's data ring)")
    return ap.parse_args(argv)


def main(argv=None):
    """Sweep, Continue, lint, save.  Returns what it measured (both
    reports, both plans and the paths), for callers that check it."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    resolve_device(args.device)             # no card: raise before any I/O
    work = tempfile.gettempdir()
    spec = json.loads(json.dumps(SWEEP_SPEC))
    if args.smoke:
        cfg = get_arch("stablelm-3b").smoke()
        shape = get_shape("train_4k").smoke()
        executor = "dryrun"
    else:
        cfg = dataclasses.replace(get_arch("stablelm-3b"),
                                  num_layers=args.layers)
        shape = ShapeConfig("train-2x2048", 2048, 2, "train")
        executor = "wallclock"
        # on the card the clause axis also races the hand-written kernels
        spec["clauses"]["kernel"] = ["plain", "cuda"]
    made_group = False
    if args.mesh_space:
        from repro_torch.launch.mesh import ensure_group, world_size
        made_group = world_size() is None
        ensure_group(torch.device(args.device).type)
        kind = torch.device(args.device).type
        spec["meshes"] = [None, {"data": world_size(), "device_kind": kind}]
    spec_path = os.path.join(work, "sweep_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=2)
    print(f"sweep spec written to {spec_path}")
    print(f"arch={cfg.name}  d_model={cfg.d_model}  layers={cfg.num_layers}"
          f"  shape={shape.name} ({shape.global_batch}x{shape.seq_len})  "
          f"executor={executor}  device={args.device}")

    sweep_spec = load_sweep_json(spec_path)
    db_path = os.path.join(work, "compar_sweep.db")
    for p in (db_path, db_path + "-wal", db_path + "-shm"):
        if os.path.exists(p):
            os.remove(p)
    db = SweepDB(db_path)

    workers = 1 if args.backend == "sequential" else (os.cpu_count() or 1)
    if args.remote_url:
        print(f"scoring remotely against {args.remote_url}")
    # first run: New mode, parallel scoring + exact lower-bound pruning
    # (the dry run only: a wall-clock sweep takes one worker and no prune),
    # the JSON spec's "globals" grid as the outer knob axis
    with ComParTuner(cfg, shape, device=args.device, db=db,
                     project="json-demo", mode="new",
                     executor=executor) as tuner:
        plan, rep = tuner.sweep(spec=sweep_spec, max_flags=1,
                                backend=args.backend, workers=workers,
                                prune=True, remote_url=args.remote_url,
                                remote_token=args.remote_token)
    print("first run:", rep.summary())
    assert rep.n_knob_points == 2
    print("per-knob fused totals:", rep.per_knob_total_s)
    if sweep_spec.meshes is not None:
        assert rep.n_mesh_points == len(sweep_spec.meshes)
        assert plan.mesh is not None        # the topology was chosen
        print("per-mesh fused totals:", rep.per_mesh_total_s)

    # second run: Continue mode, everything settled, near-instant
    db2 = SweepDB(db_path)
    with ComParTuner(cfg, shape, device=args.device, db=db2,
                     project="json-demo", mode="continue",
                     executor=executor) as tuner2:
        plan2, rep2 = tuner2.sweep(spec=sweep_spec, max_flags=1,
                                   backend=args.backend,
                                   remote_url=args.remote_url,
                                   remote_token=args.remote_token)
    print("continue run:", rep2.summary())
    assert rep2.n_scored == 0 and rep2.elapsed_s < rep.elapsed_s
    assert plan2.knobs == plan.knobs       # the joint argmin is stable
    assert plan2.mesh == plan.mesh
    print("\nfused plan (knobs chosen by the sweep, not supplied):")
    print(plan2.describe())

    # certify + persist the winner: the saved JSON is what a training job
    # takes, and what the lint CLI re-checks
    #   python -m repro_torch.analysis.lint <plan.json>
    diags = plan2.lint(cfg, shape)
    assert not diags, f"fused plan failed its own lint: {diags}"
    plan_path = os.path.join(work, "compar_sweep_plan.json")
    plan2.save(plan_path)
    print(f"fused plan written to {plan_path} (lint: clean)")
    db.conn.close()
    db2.conn.close()
    if made_group:
        from repro_torch.launch.mesh import destroy_group
        destroy_group()
    return {"cfg": cfg, "shape": shape, "report": rep, "report2": rep2,
            "plan": plan, "plan2": plan2, "plan_path": plan_path,
            "db_path": db_path}


if __name__ == "__main__":
    main()
