"""End-to-end training example, the port's counterpart of the reference's
``examples/train_e2e.py``: train xLSTM through ``launch/train.py`` on the
synthetic-language pipeline, with async checkpoints and a simulated crash
at the halfway point, then resume from the latest checkpoint.

    python -m repro_torch.examples.train_e2e --full --steps 20   # the card
    python -m repro_torch.examples.train_e2e --device cpu --steps 4

Without ``--full`` the model is xlstm-125m's smoke config; ``--full`` is
the real xlstm-125m (~0.15 B parameters).  Both run B=8, S=64.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch.train import train


def main(argv=None):
    """Phase 1 (steps 0..N/2, then the simulated crash) and phase 2 (the
    restart, to N).  Returns both phases' losses."""
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.examples.train_e2e")
    ap.add_argument("--full", action="store_true",
                    help="the real xlstm-125m (default: its smoke config)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: under $TMPDIR)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    resolve_device(args.device)             # no card: raise before any I/O

    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_e2e_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--arch", "xlstm-125m", "--ckpt-dir", ckpt,
            "--ckpt-every", "25", "--log-every", "10",
            "--batch", "8", "--seq", "64", "--device", args.device]
    if not args.full:
        base.insert(2, "--smoke")

    half = args.steps // 2
    print(f"=== phase 1: steps 0..{half} (then simulated crash) ===")
    first = train(base + ["--steps", str(half)])

    print(f"\n=== phase 2: restart from latest checkpoint, steps "
          f"{half}..{args.steps} ===")
    second = train(base + ["--steps", str(args.steps)])
    print(f"\nfinal loss after restart-resume: {second[-1]:.4f}")
    print("fault-tolerance contract held: data + RNG replayed exactly "
          "from the checkpoint step.")
    return {"first": first, "second": second, "ckpt": ckpt}


if __name__ == "__main__":
    main()
