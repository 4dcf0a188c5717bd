"""Checkpointing: atomic, async, keep-N garbage-collected.

The reference's protocol (``src/repro/checkpoint/store.py``):

* **Atomic commit**: write to ``step_XXXXXXXX.tmp/``, rename, then write
  ``manifest.json`` last (through a renamed, fsynced temporary); a step
  directory without a manifest is ignored, so a crash mid-write never
  corrupts a restart.
* **Async**: ``save_async`` copies the tensors to host memory now and
  writes them from a background thread while training goes on.
* **Keep-N GC**, and the data position in ``extra``, so a restart replays.

A state is a dict of named trees: nested dicts of tensors, with
``NamedTuple`` nodes (the AdamW state) and Python ints (its step) as
leaves too.  Each tree is one ``.npz`` of its flattened leaves, keyed by
path; a bf16 leaf is stored as its uint16 bits (numpy has no bf16) and
``index.json`` records which.  ``restore`` rebuilds each tree in the shape
of a given one, on that tree's devices and in its dtypes, and marks a leaf
trainable where the given leaf was.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _host_tree(tree) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """(path -> host array, the paths of the bf16 leaves)."""
    flat = _flatten(tree)
    bf16 = sorted(k for k, v in flat.items()
                  if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16)
    return {k: _host(v) for k, v in flat.items()}, bf16


def _unflatten(tree_like, flat: Dict[str, np.ndarray], bf16, prefix=""):
    if isinstance(tree_like, tuple) and hasattr(tree_like, "_fields"):
        return type(tree_like)(**_unflatten(tree_like._asdict(), flat, bf16,
                                            prefix))
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, bf16, f"{prefix}{k}/")
                for k, v in tree_like.items()}
    key = prefix[:-1]
    arr = flat[key]
    if not isinstance(tree_like, torch.Tensor):
        return type(tree_like)(arr.item())
    t = torch.from_numpy(np.array(arr))
    if key in bf16:
        t = t.view(torch.bfloat16)
    t = t.to(device=tree_like.device, dtype=tree_like.dtype)
    return t.requires_grad_(tree_like.requires_grad)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None):
        """Synchronous atomic save. ``state``: name -> tree."""
        return self._write(step, {name: _host_tree(tree)
                                  for name, tree in state.items()}, extra)

    def save_async(self, step: int, state: Dict[str, Any],
                   extra: Optional[Dict] = None):
        """Copy to host memory now, write in the background."""
        host = {name: _host_tree(tree) for name, tree in state.items()}
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra), daemon=True)
        self._thread.start()

    def _write(self, step: int, host, extra: Optional[Dict]):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {}
        for name, (flat, bf16) in host.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
            index[name] = {"keys": sorted(flat), BF16: bf16}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):       # a step written again replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        manifest = {"step": step, "time": time.time(),
                    "extra": extra or {}, "names": sorted(host)}
        mpath = os.path.join(final, MANIFEST)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mpath + ".tmp", mpath)
        self._gc()
        return final

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, MANIFEST)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any], Dict]:
        """Restore the named trees of ``tree_like`` from ``step`` (default
        the latest).  Returns (step, state, the manifest's ``extra``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        out = {}
        for name, tree in tree_like.items():
            with np.load(os.path.join(d, f"{name}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            out[name] = _unflatten(tree, flat, set(index[name][BF16]))
        return step, out, manifest.get("extra", {})

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

