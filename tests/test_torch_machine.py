"""The port's calibrated machine model (``core/machine.py``) against the JAX
package's, on the CPU.

Pure functions are exact: ``profile_key``, the profile's JSON and content
hash, and ``hardware_from_profile``'s measured fields on one hand-made
profile (the base constants differ by design: the port falls back to
``H100``, the reference to ``V5E``; given one base, the views are equal).
``calibrate(tiny=True)`` runs for real on the CPU (its readings are only
held > 0: a CPU rate is no device metric).  The tuner's ``machine=`` keeps
calibrated rows apart from constant-model rows; the bound stays under the
score (``audit_soundness``).
"""
import dataclasses
import json
import logging
import time

import pytest

from repro.core import cost_model as JCM
from repro.core import machine as JM
from repro.core.db import SweepDB as JSweepDB
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import cost_model as TCM
from repro_torch.core import machine as TM
from repro_torch.core.db import SweepDB
from repro_torch.core.tuner import ComParTuner

KIND = "NVIDIA H100 80GB HBM3"


def _profile(pkg, **kw):
    fields = dict(platform="cuda", device_kind=KIND, n_devices=1,
                  peak_flops={"bfloat16": 7.1e14, "float32": 5.2e13},
                  hbm_bw=3.05e12, collectives={},
                  meta={"tiny": False, "repeats": 3})
    fields.update(kw)
    return pkg.MachineProfile(**fields)


@pytest.mark.parametrize("platform,kind,n", [("cuda", KIND, 1),
                                             ("cpu", "cpu", 1),
                                             ("cuda", KIND, 4)])
def test_profile_key_matches_reference(platform, kind, n):
    assert TM.PROFILE_VERSION == JM.PROFILE_VERSION
    assert TM.profile_key(platform, kind, n) == \
        JM.profile_key(platform, kind, n)


def test_profile_json_roundtrip_and_pid_match_reference():
    coll = {"all_reduce:data=4:4194304": {"s": 1e-4, "bytes": 6.3e6,
                                          "bytes_s": 6.3e10}}
    for extra in ({}, {"collectives": coll}):
        t, j = _profile(TM, **extra), _profile(JM, **extra)
        assert t.to_json() == j.to_json()
        assert t.pid == j.pid and t.key == j.key
        back = TM.MachineProfile.from_json(json.loads(json.dumps(
            t.to_json())))
        assert back == t and back.pid == t.pid
        assert t.best_link_bw() == j.best_link_bw()


def test_hardware_from_profile_matches_reference_measured_fields():
    coll = {"all_reduce:data=4:4194304": {"s": 1e-4, "bytes": 6.3e6,
                                          "bytes_s": 6.3e10}}
    for extra in ({}, {"collectives": coll},
                  {"peak_flops": {}, "hbm_bw": 0.0}):
        t, j = _profile(TM, **extra), _profile(JM, **extra)
        th, jh = TM.hardware_from_profile(t), JM.hardware_from_profile(j)
        assert th.name == jh.name == f"cal1-cuda-{t.pid[:8]}"
        for f in ("peak_flops", "hbm_bw", "link_bw"):
            measured = {"peak_flops": max(t.peak_flops.values(), default=0),
                        "hbm_bw": t.hbm_bw,
                        "link_bw": t.best_link_bw()}[f]
            if measured:
                assert getattr(th, f) == getattr(jh, f) == measured, f
            else:           # unmeasured: each package's own base constant
                assert getattr(th, f) == getattr(TCM.H100, f), f
                assert getattr(jh, f) == getattr(JCM.V5E, f), f
        # one base: the views are equal field for field
        base = dataclasses.asdict(TCM.H100)
        assert dataclasses.asdict(JM.hardware_from_profile(
            j, base=JCM.Hardware(**base))) == dataclasses.asdict(th)
    # the bf16 rate sets peak_flops (the constant's meaning)
    assert TM.hardware_from_profile(_profile(TM)).peak_flops == 7.1e14


def _fake_calibrate(calls):
    def calibrate(tiny=False, repeats=3, device="cuda"):
        calls.append(tiny)
        return _profile(TM, platform="cpu", device_kind="cpu",
                        meta={"tiny": tiny})
    return calibrate


def test_load_or_calibrate_caches_and_recalibrates_stale(monkeypatch):
    calls = []
    monkeypatch.setattr(TM, "calibrate", _fake_calibrate(calls))
    db = SweepDB()
    first = TM.load_or_calibrate(db, device="cpu")
    again = TM.load_or_calibrate(db, device="cpu")
    assert calls == [False] and again == first
    # the port's CPU key is the reference's on the CPU: one machine_cache
    jdb = JSweepDB()
    assert first.key == TM.profile_key("cpu", "cpu", 1)
    jdb.machine_put(first.key, first.pid, first.to_json())
    assert JM.MachineProfile.from_json(jdb.machine_get(first.key)).pid == \
        first.pid
    # a stale version under the key is recalibrated, never trusted
    stale = dict(first.to_json(), version=0)
    db.machine_put(first.key, "old", stale)
    TM.load_or_calibrate(db, device="cpu")
    assert calls == [False, False]
    db.conn.execute("UPDATE machine_cache SET profile='{' WHERE key=?",
                    (first.key,))
    TM.load_or_calibrate(db, device="cpu")
    assert len(calls) == 3
    TM.load_or_calibrate(db, device="cpu", force=True)
    assert len(calls) == 4


def test_calibrate_tiny_on_cpu():
    t0 = time.perf_counter()
    prof = TM.calibrate(tiny=True, repeats=2, device="cpu")
    assert time.perf_counter() - t0 < 10
    assert prof.key == "machine:v1:cpu:cpu:1" and prof.collectives == {}
    assert set(prof.peak_flops) == {"bfloat16", "float32"}
    assert all(v > 0 for v in prof.peak_flops.values()) and prof.hbm_bw > 0
    assert prof.meta["tiny"] and prof.meta["matmul_sizes"] == [128, 256]
    assert prof.meta["float32_matmul"] == "highest"


def test_resolve_machine(monkeypatch):
    calls = []
    monkeypatch.setattr(TM, "calibrate", _fake_calibrate(calls))
    db = SweepDB()
    assert TM.resolve_machine(None, db) is None
    assert TM.resolve_machine(TCM.H100, db) is TCM.H100
    prof = _profile(TM)
    assert TM.resolve_machine(prof, db) == TM.hardware_from_profile(prof)
    hw = TM.resolve_machine("auto", db, device="cpu")
    assert calls == [True]             # the CPU takes the tiny ladder
    assert hw.name.startswith("cal1-cpu-")
    with pytest.raises(ValueError, match="machine must be"):
        TM.resolve_machine("fast", db)


def test_tuner_machine_keeps_calibrated_rows_apart(caplog):
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    db = SweepDB()
    kw = dict(providers=["fsdp"], clause_space={"remat": ("none", "dots")},
              max_flags=0)
    const = ComParTuner(cfg, shape, device="cpu", db=db, project="c")
    const.sweep(**kw)
    prof = _profile(TM, platform="cpu", device_kind="cpu",
                    peak_flops={"bfloat16": 2e12, "float32": 1e12},
                    hbm_bw=5e10)
    cal = ComParTuner(cfg, shape, device="cpu", db=db, project="k",
                      machine=prof)
    assert cal.executor.cache_tag == f"dryrun:cal1-cpu-{prof.pid[:8]}"
    assert cal.executor.cache_tag != const.executor.cache_tag
    plan, rep = cal.sweep(**kw)
    assert rep.n_cached == 0 and rep.n_scored > 0
    envs = {m for (m,) in db.conn.execute("SELECT mesh FROM score_cache")}
    assert envs == {f"local/{const.executor.cache_tag}",
                    f"local/{cal.executor.cache_tag}"}
    cal.audit_soundness()
    # the calibrated model's slower rates predict longer times
    c = {r["cid"]: r["cost"]["total_s"] for r in db.results("c")}
    k = {r["cid"]: r["cost"]["total_s"] for r in db.results("k")}
    assert all(k[cid] > c[cid] for cid in c)
    with caplog.at_level(logging.WARNING, logger="repro_torch.tuner"):
        wc = ComParTuner(cfg, shape, device="cpu", executor="wallclock",
                         machine=prof)
    assert "machine= ignored" in caplog.text
    assert wc.executor.cache_tag.startswith("wallclock:")


def test_machine_cli_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "m.db")
    assert TM.main(["--tiny", "--device", "cpu", "--db", path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["key"] == "machine:v1:cpu:cpu:1" and out["meta"]["tiny"]
    assert SweepDB(path).machine_get(out["key"])["hbm_bw"] == out["hbm_bw"]
