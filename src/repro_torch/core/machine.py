"""Calibrated per-device machine model, as the reference's
``src/repro/core/machine.py``.

``cost_model.Hardware`` ships the H100 SXM data sheet's *constants*; a
card set below its 700 W limit, another part or the CPU reaches other
rates, so the dry run's predictions sit below or above the real scores
by a factor the constants cannot see.  This module measures what THIS
host's device does: a matmul ladder per dtype (achievable FLOP/s), and a
stream probe (achievable HBM bytes/s), and persists the result as a
versioned :class:`MachineProfile` in the ``machine_cache`` table beside
``score_cache``.

The probes, on a CUDA device (CUDA events, a warm-up first, the best of
``repeats`` timed windows of several back-to-back launches each):

* **matmul ladder**: square products of 2048, 4096 and 8192 per dtype.
  The bf16 rows read the tensor cores; a product of 128 or 256 (the
  reference's tiny ladder) finishes in a few microseconds on an H100 and
  would read the card at ~1% of its rate.  The **f32 probe measures the
  plain f32 rate** (the CUDA cores, no TF32): it runs with
  ``torch.get_float32_matmul_precision() == "highest"``, which is also
  PyTorch's default, and restores the caller's setting after.  The
  operands are seeded normal draws, not the reference's ones: an H100's
  clock falls with the power a product draws, and a product of ones
  draws less than a model's, so it would read a rate the model's
  products do not reach.
* **stream**: ``y = x * c`` over 1 GiB of f32 (read once, written once,
  2 GiB of traffic), far past the H100's 50 MB L2, which would flatter a
  smaller probe such as the reference's 64 MiB.

``tiny=True`` keeps the reference's sizes (128 and 256 square, a 4 MiB
stream): it is for the CPU, where the wall clock times each call.

Resolution happens at the scorer, as the reference's: the tuner
calibrates or loads its own device's profile and views it as a
:class:`~repro_torch.core.cost_model.Hardware` via
:func:`hardware_from_profile`, with the H100 constants as the fallback for
anything unmeasured.  The view's ``name`` embeds the profile's content
hash, so ``DryRunExecutor.cache_tag`` (``dryrun:<hw.name>``) keeps
calibrated scores apart from constant-model scores.

Soundness, as the reference's: the lower bound and the dry-run score
divide by the same executor ``hw``, so ``bound <= score`` holds under any
profile.

Collective probes run over the default process group's ranks, a flat
ring, as the reference's run over all local devices: ``all_reduce`` and
``all_gather_into_tensor``, every rank calling ``calibrate``.  Without a
group, or at world size 1, there are none (the reference has none on one
device), and ``link_bw`` keeps its constant.

CLI: ``python -m repro_torch.core.machine [--db PATH] [--tiny] [--force]
[--device cpu]``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import time
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import torch

from repro_torch.core.cost_model import H100, Hardware
from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.machine")

#: bump on any change to what the microbenchmarks measure or how the
#: profile is keyed: old rows can then never alias new semantics.
PROFILE_VERSION = 1

#: matmul ladder sizes (square, per dtype); tiny = the reference's CPU sizes
_MATMUL_SIZES = (2048, 4096, 8192)
_MATMUL_SIZES_TINY = (128, 256)
#: stream probe array bytes (read once, written once)
_STREAM_BYTES = 1 << 30          # 1 GiB, 20x the H100's L2
_STREAM_BYTES_TINY = 1 << 22     # 4 MiB
#: bytes per rank of a collective probe (the reference's sizes)
_COLL_BYTES = 1 << 22
_COLL_BYTES_TINY = 1 << 18
#: launches between two CUDA events (one timed window)
_INNER = 8
_DTYPES = ("bfloat16", "float32")


def profile_key(platform: str, device_kind: str, n_devices: int) -> str:
    """Versioned machine identity: the ``machine_cache`` primary key."""
    return f"machine:v{PROFILE_VERSION}:{platform}:{device_kind}:{n_devices}"


@dataclass(frozen=True)
class MachineProfile:
    """Measured capabilities of one host's devices.

    ``peak_flops`` maps dtype name -> achieved FLOP/s per device;
    ``hbm_bw`` is achieved stream bytes/s per device; ``collectives``
    maps ``"<kind>:<axis>=<size>:<shard_bytes>"`` -> {"s", "bytes",
    "bytes_s"} (empty below two ranks in the default group).
    """
    platform: str
    device_kind: str
    n_devices: int
    peak_flops: Dict[str, float] = field(default_factory=dict)
    hbm_bw: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)
    version: int = PROFILE_VERSION

    @property
    def key(self) -> str:
        return profile_key(self.platform, self.device_kind, self.n_devices)

    @property
    def pid(self) -> str:
        """Content hash: equal measurements -> equal id, on any host."""
        return hashlib.sha1(
            json.dumps(self.to_json(), sort_keys=True).encode()).hexdigest()

    def to_json(self) -> Dict:
        return {"platform": self.platform, "device_kind": self.device_kind,
                "n_devices": self.n_devices,
                "peak_flops": dict(self.peak_flops), "hbm_bw": self.hbm_bw,
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()},
                "meta": dict(self.meta), "version": self.version}

    @classmethod
    def from_json(cls, d: Dict) -> "MachineProfile":
        return cls(platform=d["platform"], device_kind=d["device_kind"],
                   n_devices=int(d["n_devices"]),
                   peak_flops={k: float(v) for k, v in
                               (d.get("peak_flops") or {}).items()},
                   hbm_bw=float(d.get("hbm_bw") or 0.0),
                   collectives={k: {kk: float(vv) for kk, vv in v.items()}
                                for k, v in
                                (d.get("collectives") or {}).items()},
                   meta=dict(d.get("meta") or {}),
                   version=int(d.get("version", 0)))

    def best_link_bw(self) -> float:
        """Best measured collective bytes/s (0.0 when none is measured)."""
        return max((v.get("bytes_s", 0.0)
                    for v in self.collectives.values()), default=0.0)


def _identity(dev: torch.device):
    """(platform, device kind, device count) of ``dev``'s host."""
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev), \
            torch.cuda.device_count()
    return dev.type, dev.type, 1


# --- microbenchmarks ---------------------------------------------------------

def _time_best(fn, dev: torch.device, repeats: int) -> float:
    """Best seconds of one call of ``fn`` (first call warms).  On CUDA each
    timed window is ``_INNER`` back-to-back calls between two events; on
    the CPU the wall clock times one call."""
    fn()
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(max(1, repeats)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(_INNER):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / _INNER)
        return best
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _matmul_peak(dtype: str, sizes, repeats: int, dev) -> float:
    best = 0.0
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in sizes:
        x = torch.randn((n, n), generator=gen, device=dev).to(dt)
        y = torch.randn((n, n), generator=gen, device=dev).to(dt)
        out = torch.empty((n, n), dtype=dt, device=dev)
        t = _time_best(lambda: torch.mm(x, y, out=out), dev, repeats)
        del x, y, out
        if t > 0:
            best = max(best, 2.0 * n ** 3 / t)
    return best


def _stream_bw(nbytes: int, repeats: int, dev) -> float:
    n = max(1, nbytes // 4)
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    # one read and one write a call: the scale defeats copy elision
    t = _time_best(lambda: torch.mul(x, 1.000001, out=y), dev, repeats)
    return 2.0 * x.nbytes / t if t > 0 else 0.0


def _collective_points(shard_bytes: int, repeats: int,
                       dev) -> Dict[str, Dict[str, float]]:
    """All-reduce / all-gather over the default group's flat ring (every
    rank calls this), keyed and counted as the reference's: all-reduce
    moves ``2*r*(n-1)/n`` bytes per device, all-gather ``r*(n-1)/n``, so
    ``bytes_s`` is in ``Hardware.link_bw``'s units.  None below two
    ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import world_size
    n = world_size() or 1
    out: Dict[str, Dict[str, float]] = {}
    if n < 2:
        return out
    rows = max(1, shard_bytes // 4)
    r = rows * 4                                     # shard bytes per rank
    x = torch.ones((rows,), dtype=torch.float32, device=dev)
    gathered = torch.empty((rows * n,), dtype=torch.float32, device=dev)
    probes = {
        "all_reduce": (lambda: dist.all_reduce(x),
                       2.0 * r * (n - 1) / n),
        "all_gather": (lambda: dist.all_gather_into_tensor(gathered, x),
                       1.0 * r * (n - 1) / n),
    }
    for kind, (body, conv_bytes) in probes.items():
        t = _time_best(body, dev, repeats)
        if t > 0:
            out[f"{kind}:data={n}:{r}"] = {
                "s": t, "bytes": conv_bytes, "bytes_s": conv_bytes / t}
    return out


def calibrate(tiny: bool = False, repeats: int = 3,
              device="cuda") -> MachineProfile:
    """Run the microbenchmark suite on ``device`` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    platform, device_kind, n = _identity(dev)
    t0 = time.perf_counter()
    sizes = _MATMUL_SIZES_TINY if tiny else _MATMUL_SIZES
    stream = _STREAM_BYTES_TINY if tiny else _STREAM_BYTES
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")     # f32: no TF32
    try:
        peaks = {dt: _matmul_peak(dt, sizes, repeats, dev) for dt in _DTYPES}
    finally:
        torch.set_float32_matmul_precision(precision)
    peaks = {k: v for k, v in peaks.items() if v > 0}
    bw = _stream_bw(stream, repeats, dev)
    coll = _collective_points(_COLL_BYTES_TINY if tiny else _COLL_BYTES,
                              repeats, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prof = MachineProfile(
        platform=platform, device_kind=device_kind, n_devices=n,
        peak_flops=peaks, hbm_bw=bw, collectives=coll,
        meta={"tiny": bool(tiny), "repeats": int(repeats),
              "calibrated_s": round(time.perf_counter() - t0, 3),
              "matmul_sizes": list(sizes), "stream_bytes": int(stream),
              "float32_matmul": "highest"})
    log.info("calibrated %s: peak=%s hbm_bw=%.3g (%.1fs)", prof.key,
             {k: f"{v:.3g}" for k, v in peaks.items()}, bw,
             prof.meta["calibrated_s"])
    return prof


def load_or_calibrate(db, tiny: bool = False, force: bool = False,
                      device="cuda") -> MachineProfile:
    """Resolve this host's profile against ``db.machine_cache``.

    Version-mismatched or unreadable rows are recalibrated, never
    trusted, as versioned executor cache tags are."""
    dev = resolve_device(device)
    key = profile_key(*_identity(dev))
    if not force:
        row = db.machine_get(key)
        if row is not None:
            try:
                prof = MachineProfile.from_json(row)
                if prof.version == PROFILE_VERSION and prof.key == key:
                    return prof
            except (KeyError, TypeError, ValueError):
                pass
            log.warning("stale/corrupt machine profile %s: recalibrating", key)
    prof = calibrate(tiny=tiny, device=dev)
    db.machine_put(prof.key, prof.pid, prof.to_json())
    return prof


def hardware_from_profile(profile: MachineProfile,
                          base: Hardware = H100) -> Hardware:
    """View a profile as the scorer's ``Hardware``; unmeasured fields fall
    back to ``base``'s constants.

    ``peak_flops`` takes the best dtype on the ladder, as the reference's:
    on an H100 that is the bf16 rate, the meaning of the constant
    (``cost_model.Hardware.peak_flops``).  ``link_bw`` takes the best
    measured collective point.  The name embeds the profile hash, so
    ``DryRunExecutor.cache_tag`` keys calibrated scores apart per profile.
    """
    peak = max(profile.peak_flops.values(), default=0.0)
    link = profile.best_link_bw()
    return replace(
        base,
        name=f"cal{PROFILE_VERSION}-{profile.platform}-{profile.pid[:8]}",
        peak_flops=peak or base.peak_flops,
        hbm_bw=profile.hbm_bw or base.hbm_bw,
        link_bw=link or base.link_bw)


def resolve_machine(machine, db, device="cuda") -> Optional[Hardware]:
    """The tuner's resolution of a ``machine=`` argument.

    ``None`` -> None (keep the constant model); ``"auto"`` ->
    load-or-calibrate against ``db`` on ``device``: the full ladder on a
    card (the tiny one would read it at ~1% of its rate), the tiny one on
    the CPU; a :class:`MachineProfile` -> its Hardware view; a
    :class:`Hardware` -> itself.
    """
    if machine is None:
        return None
    if isinstance(machine, Hardware):
        return machine
    if isinstance(machine, MachineProfile):
        return hardware_from_profile(machine)
    if machine == "auto":
        dev = resolve_device(device)
        return hardware_from_profile(
            load_or_calibrate(db, tiny=dev.type != "cuda", device=dev))
    raise ValueError(f"machine must be None, 'auto', a MachineProfile or "
                     f"a Hardware; got {machine!r}")


def main(argv=None) -> int:
    """CLI: calibrate this host and persist/print the profile."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.machine",
                                 description="machine calibration")
    ap.add_argument("--db", default="", help="sweep DB path (persist here)")
    ap.add_argument("--tiny", action="store_true",
                    help="the reference's small ladder (for the CPU)")
    ap.add_argument("--force", action="store_true", help="recalibrate even "
                    "if a cached profile exists")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.db:
        from repro_torch.core.db import SweepDB
        db = SweepDB(args.db)
        prof = load_or_calibrate(db, tiny=args.tiny, force=args.force,
                                 device=args.device)
    else:
        prof = calibrate(tiny=args.tiny, repeats=args.repeats,
                         device=args.device)
    print(json.dumps({"key": prof.key, "pid": prof.pid,
                      **prof.to_json()}, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
