"""Sweep DB: sqlite-backed combination/result store with ComPar's three
operational modes — **New**, **Overwrite**, **Continue** — as the
reference's ``src/repro/core/db.py``, with its schema unchanged.

A row swept over the mesh axis records its
:class:`~repro_torch.core.meshspec.MeshSpec` in its spec, and the score
cache's mesh column holds the point's ``mid`` (``"local"`` meshless).  The
``machine_*``, ``kernel_*`` and ``plan_*`` tables are plain table access;
their users are ``core/machine.py`` (the calibrated machine profile),
``kernels/autotune.py`` (the kernel schedules' timings) and
``serve/registry.py`` (the plan registry).

Continue mode is the sweep's fault tolerance: a crashed or preempted sweep
resumes without re-running finished combinations (paper §4.2), and it is
also how more combinations are appended to an existing project.
"""
from __future__ import annotations

import json
import sqlite3
import time
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.combinator import Combination, GlobalKnobs, row_cid
from repro_torch.core.meshspec import MeshSpec

_SCHEMA = """
CREATE TABLE IF NOT EXISTS projects (
    name TEXT PRIMARY KEY,
    created REAL,
    config TEXT
);
CREATE TABLE IF NOT EXISTS combinations (
    project TEXT,
    segment TEXT,
    cid TEXT,
    spec TEXT,
    status TEXT DEFAULT 'pending',   -- pending | done | failed | invalid
                                     --   | pruned | static
    cost TEXT,
    error TEXT,
    updated REAL,
    PRIMARY KEY (project, segment, cid)
);
CREATE TABLE IF NOT EXISTS score_cache (
    signature TEXT,                  -- Segment.signature(cfg, shape)
    shape TEXT,                      -- shape content key
    mesh TEXT,                       -- mesh content key ('local' = no mesh)
    cid TEXT,                        -- effective combination id
    status TEXT,                     -- done | failed
    cost TEXT,
    error TEXT,
    created REAL,
    total_s REAL,                    -- denormalized cost for keep-best upserts
    PRIMARY KEY (signature, shape, mesh, cid)
);
CREATE TABLE IF NOT EXISTS machine_cache (
    key TEXT PRIMARY KEY,            -- machine.profile_key(): versioned host id
    pid TEXT,                        -- profile content hash
    profile TEXT,                    -- MachineProfile JSON
    created REAL
);
CREATE TABLE IF NOT EXISTS kernel_cache (
    key TEXT,                        -- autotune.cache_key(): versioned
                                     --   kernel:v<N>:<tag>:<op>:<dims>
    variant TEXT,                    -- canonical schedule key (k=v join)
    status TEXT,                     -- done | failed
    time_s REAL,
    flops REAL,
    error TEXT,
    created REAL,
    PRIMARY KEY (key, variant)
);
CREATE TABLE IF NOT EXISTS plan_registry (
    arch TEXT,                       -- ArchConfig name
    shape TEXT,                      -- shape_key(): kind:seq_lenxbatch
    kind TEXT,                       -- shape kind (nearest-lookup filter)
    seq_len INTEGER,
    batch INTEGER,
    mesh TEXT,                       -- MeshSpec mid ('local' = no mesh)
    cache_tag TEXT,                  -- executor tag the plan was scored under
    plan TEXT,                       -- Plan.to_json blob
    total_s REAL,                    -- fused predicted total (argmin value)
    report TEXT,                     -- sweep report summary JSON
    created REAL,
    PRIMARY KEY (arch, shape, mesh, cache_tag)
);
"""


class SweepDB:
    def __init__(self, path: str = ":memory:"):
        # The sweep engine is the only writer, so a single shared
        # connection is safe.  ``path`` is kept for read-only views of the
        # score cache (ScoreCacheReader; WAL allows concurrent readers).
        self.path = path
        self.conn = sqlite3.connect(path, check_same_thread=False)
        # WAL keeps readers off the writer's back on file-backed DBs and
        # makes batched commits cheap; both pragmas are no-ops on :memory:.
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    # --- project modes -----------------------------------------------------
    def open_project(self, name: str, mode: str = "new",
                     config: Optional[Dict] = None) -> str:
        """Returns the (possibly suffixed) project name actually used."""
        cur = self.conn.execute(
            "SELECT name FROM projects WHERE name=?", (name,))
        exists = cur.fetchone() is not None
        if mode == "new":
            final = name
            i = 1
            while self._exists(final):
                final = f"{name}_{i}"       # append incremental index
                i += 1
        elif mode == "overwrite":
            final = name
            if exists:
                self.conn.execute(
                    "DELETE FROM combinations WHERE project=?", (name,))
                self.conn.execute(
                    "DELETE FROM projects WHERE name=?", (name,))
        elif mode == "continue":
            final = name
            if exists:
                self.conn.commit()
                return final
        else:
            raise ValueError(f"unknown mode {mode!r}")
        self.conn.execute(
            "INSERT INTO projects VALUES (?,?,?)",
            (final, time.time(), json.dumps(config or {})))
        self.conn.commit()
        return final

    def _exists(self, name: str) -> bool:
        cur = self.conn.execute(
            "SELECT 1 FROM projects WHERE name=?", (name,))
        return cur.fetchone() is not None

    # --- combinations ------------------------------------------------------
    def register(self, project: str, segment: str, combo: Combination):
        self.register_many(project, [(segment, combo)])

    def register_many(self, project: str, items: Iterable[Tuple]):
        """Register (segment, combination[, knobs[, mesh]]) rows in ONE
        transaction.

        Items are ``(segment, combo)`` 2-tuples, ``(segment, combo,
        knobs)`` 3-tuples — the knob axis — or ``(segment, combo, knobs,
        mesh)`` 4-tuples, ``mesh`` the swept MeshSpec point (``None`` =
        the mesh is not swept).  The row id is
        ``combinator.row_cid(combo, knobs, mesh)`` and the spec records
        the knob and mesh points for per-point fusion grouping.
        """
        now = time.time()
        rows = []
        for item in items:
            seg, c = item[0], item[1]
            kn = item[2] if len(item) > 2 else None
            mesh = item[3] if len(item) > 3 else None
            spec = c.to_json()
            if kn is not None:
                spec["knobs"] = kn.to_json()
            if mesh is not None:
                spec["mesh"] = mesh.to_json()
            rows.append((project, seg, row_cid(c, kn, mesh),
                         json.dumps(spec), now))
        self.conn.executemany(
            "INSERT OR IGNORE INTO combinations "
            "(project, segment, cid, spec, updated) VALUES (?,?,?,?,?)",
            rows)
        self.conn.commit()

    def status(self, project: str, segment: str, cid: str) -> Optional[str]:
        cur = self.conn.execute(
            "SELECT status FROM combinations WHERE project=? AND segment=? "
            "AND cid=?", (project, segment, cid))
        row = cur.fetchone()
        return row[0] if row else None

    def statuses(self, project: str) -> Dict[Tuple[str, str], str]:
        """All (segment, cid) -> status in one query (the resume check)."""
        return {(seg, cid): st for seg, cid, st in self.conn.execute(
            "SELECT segment, cid, status FROM combinations WHERE project=?",
            (project,))}

    def record(self, project: str, segment: str, cid: str, *,
               status: str, cost: Optional[Dict] = None,
               error: str = ""):
        """Record a result for a REGISTERED combination; raises KeyError on
        an unknown row instead of silently dropping the result (an UPDATE
        that matches nothing)."""
        self.record_many(project, [
            {"segment": segment, "cid": cid, "status": status,
             "cost": cost, "error": error}])

    def record_many(self, project: str, rows: Iterable[Dict]):
        """Record a batch of results in ONE transaction.

        Each row: {"segment", "cid", "status", "cost"?, "error"?}.
        Raises KeyError if any (segment, cid) was never registered.
        """
        rows = list(rows)
        if not rows:
            return
        now = time.time()
        cur = self.conn.executemany(
            "UPDATE combinations SET status=?, cost=?, error=?, updated=? "
            "WHERE project=? AND segment=? AND cid=?",
            [(r["status"], json.dumps(r.get("cost") or {}),
              r.get("error", ""), now, project, r["segment"], r["cid"])
             for r in rows])
        if cur.rowcount != len(rows):
            self.conn.rollback()
            known = self.statuses(project)
            missing = [(r["segment"], r["cid"]) for r in rows
                       if (r["segment"], r["cid"]) not in known]
            raise KeyError(
                f"record() for unregistered combination(s) in project "
                f"{project!r}: {missing or 'duplicate rows in batch'}")
        self.conn.commit()

    # --- cross-project structural score cache ------------------------------
    def cache_get(self, signature: str, shape: str, mesh: str,
                  cid: str) -> Optional[Dict]:
        cur = self.conn.execute(
            "SELECT status, cost, error FROM score_cache WHERE signature=? "
            "AND shape=? AND mesh=? AND cid=?", (signature, shape, mesh, cid))
        row = cur.fetchone()
        if row is None:
            return None
        return {"status": row[0],
                "cost": json.loads(row[1]) if row[1] else None,
                "error": row[2]}

    #: keep-best ranking of cache statuses (higher wins a conflict)
    _STATUS_RANK = "CASE %s WHEN 'done' THEN 2 WHEN 'failed' THEN 1 ELSE 0 END"

    def cache_put_many(self, entries: Iterable[Dict]):
        """entries: {"signature","shape","mesh","cid","status","cost"?,
        "error"?} — one transaction, insert-if-absent / keep-best.

        A conflicting row is replaced only when the incoming entry is
        strictly better: ``done`` beats ``failed``, and among two ``done``
        entries the lower ``total_s`` wins.  Ties keep the existing row
        (first-writer-wins), so a stale in-flight batch — another thread,
        another sweep process, or a remote scoring server's client — can
        never clobber a fresher equal-or-better score.  The comparison
        runs inside the upsert statement itself, so it is atomic even
        across processes sharing the DB file.
        """
        now = time.time()
        rows = []
        for e in entries:
            cost = e.get("cost") or {}
            rows.append((e["signature"], e["shape"], e["mesh"], e["cid"],
                         e["status"], json.dumps(cost), e.get("error", ""),
                         now, cost.get("total_s")))
        self.conn.executemany(
            "INSERT INTO score_cache "
            "(signature, shape, mesh, cid, status, cost, error, created, "
            " total_s) VALUES (?,?,?,?,?,?,?,?,?) "
            "ON CONFLICT(signature, shape, mesh, cid) DO UPDATE SET "
            "status=excluded.status, cost=excluded.cost, "
            "error=excluded.error, created=excluded.created, "
            "total_s=excluded.total_s "
            "WHERE (%s) < (%s) OR (score_cache.status='done' "
            "AND excluded.status='done' "
            # COALESCE: a legacy 'done' row whose backfill found no total
            # (cost blob without total_s) must stay beatable, not become
            # a NULL-compares-false fixed point
            "AND excluded.total_s < COALESCE(score_cache.total_s, 1e999))"
            % (self._STATUS_RANK % "score_cache.status",
               self._STATUS_RANK % "excluded.status"),
            rows)
        self.conn.commit()

    # --- calibrated machine profiles ----------------------------------------
    def machine_get(self, key: str) -> Optional[Dict]:
        cur = self.conn.execute(
            "SELECT profile FROM machine_cache WHERE key=?", (key,))
        row = cur.fetchone()
        if row is None:
            return None
        try:
            return json.loads(row[0])
        except ValueError:
            return None

    def machine_put(self, key: str, pid: str, profile: Dict):
        # recalibration replaces: newest measurement wins (the pid makes
        # the swap visible to anything that cached the old hash)
        self.conn.execute(
            "INSERT OR REPLACE INTO machine_cache VALUES (?,?,?,?)",
            (key, pid, json.dumps(profile), time.time()))
        self.conn.commit()

    # --- kernel-schedule microbenchmarks ------------------------------------
    def kernel_get(self, key: str) -> Dict[str, Dict]:
        """All measured variants under one (op, dims, tag) cache key:
        variant key -> {"status", "time_s", "flops", "error"}.  Version
        mismatches can't happen — the version lives in the key, so stale
        rows are simply never addressed (machine_cache policy)."""
        out: Dict[str, Dict] = {}
        for variant, status, time_s, flops, error in self.conn.execute(
                "SELECT variant, status, time_s, flops, error "
                "FROM kernel_cache WHERE key=?", (key,)):
            out[variant] = {"status": status,
                            "time_s": float(time_s or 0.0),
                            "flops": float(flops or 0.0),
                            "error": error or ""}
        return out

    def kernel_put_many(self, key: str, entries: Dict[str, Dict]):
        """Persist variant measurements; re-measurement replaces (the
        newest timing wins, like machine_put)."""
        now = time.time()
        self.conn.executemany(
            "INSERT OR REPLACE INTO kernel_cache VALUES (?,?,?,?,?,?,?)",
            [(key, variant, e["status"], float(e.get("time_s") or 0.0),
              float(e.get("flops") or 0.0), e.get("error", ""), now)
             for variant, e in entries.items()])
        self.conn.commit()

    # --- registered fused plans (the serving side's lookup table) -----------
    _PLAN_COLS = ("arch", "shape", "kind", "seq_len", "batch", "mesh",
                  "cache_tag", "plan", "total_s", "report", "created")

    def plan_put(self, row: Dict):
        """Register a fused plan under its deployment key ``(arch, shape,
        mesh, cache_tag)``.  INSERT OR REPLACE: a re-tuned plan for the
        same key supersedes the old one (newest-wins, like machine_put —
        the sweep that just ran has the freshest view of the hardware).
        """
        self.conn.execute(
            "INSERT OR REPLACE INTO plan_registry VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?)",
            (row["arch"], row["shape"], row["kind"], int(row["seq_len"]),
             int(row["batch"]), row["mesh"], row.get("cache_tag", ""),
             row["plan"], row.get("total_s"), row.get("report", ""),
             time.time()))
        self.conn.commit()

    def plan_get(self, arch: str, shape: str, mesh: str,
                 cache_tag: str) -> Optional[Dict]:
        cur = self.conn.execute(
            "SELECT %s FROM plan_registry WHERE arch=? AND shape=? AND "
            "mesh=? AND cache_tag=?" % ", ".join(self._PLAN_COLS),
            (arch, shape, mesh, cache_tag))
        row = cur.fetchone()
        return dict(zip(self._PLAN_COLS, row)) if row else None

    def plan_query(self, arch: Optional[str] = None,
                   kind: Optional[str] = None, mesh: Optional[str] = None,
                   cache_tag: Optional[str] = None) -> List[Dict]:
        """Registered plans matching every given filter, in a
        deterministic order (the registry's nearest-shape fallback
        tie-breaks on it)."""
        clauses, args = [], []
        for col, val in (("arch", arch), ("kind", kind), ("mesh", mesh),
                         ("cache_tag", cache_tag)):
            if val is not None:
                clauses.append(f"{col}=?")
                args.append(val)
        q = "SELECT %s FROM plan_registry" % ", ".join(self._PLAN_COLS)
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        q += " ORDER BY arch, shape, mesh, cache_tag"
        return [dict(zip(self._PLAN_COLS, r))
                for r in self.conn.execute(q, args)]

    def cache_size(self) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM score_cache").fetchone()[0]

    def results(self, project: str,
                segment: Optional[str] = None) -> List[Dict]:
        # ORDER BY rowid: registration order, so argmin tie-breaks are
        # identical across sequential/parallel/cached sweeps.
        q = ("SELECT segment, cid, spec, status, cost, error "
             "FROM combinations WHERE project=?")
        args: Tuple = (project,)
        if segment is not None:
            q += " AND segment=?"
            args = (project, segment)
        q += " ORDER BY rowid"
        out = []
        for seg, cid, spec, status, cost, error in self.conn.execute(q, args):
            sd = json.loads(spec)
            out.append({"segment": seg, "cid": cid,
                        "combo": Combination.from_json(sd),
                        "knobs": GlobalKnobs.from_json(sd["knobs"])
                        if sd.get("knobs") else None,
                        "mesh": MeshSpec.from_json(sd["mesh"])
                        if sd.get("mesh") else None,
                        "status": status,
                        "cost": json.loads(cost) if cost else None,
                        "error": error})
        return out

    def pending(self, project: str) -> List[Dict]:
        return [r for r in self.results(project) if r["status"] == "pending"]

    def done_count(self, project: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for st, n in self.conn.execute(
                "SELECT status, COUNT(*) FROM combinations WHERE project=? "
                "GROUP BY status", (project,)):
            out[st] = n
        return out


class ScoreCacheReader:
    """Read-only ``score_cache`` access for out-of-process sweep workers.

    Opens its own connection in query-only mode: a worker can read cache
    entries the parent's Recorder flushed mid-run (WAL supports concurrent
    readers under one writer) but can never write or take the write lock.
    Every failure path degrades to a cache miss — a broken reader must
    never fail a job.
    """

    def __init__(self, path: str):
        self.conn = None
        if not path or path == ":memory:":
            return              # private in-memory DBs are not shareable
        try:
            conn = sqlite3.connect(path, check_same_thread=False, timeout=1.0)
            conn.execute("PRAGMA query_only=ON")
            self.conn = conn
        except sqlite3.Error:
            self.conn = None

    def get(self, signature: str, shape: str, mesh: str,
            cid: str) -> Optional[Dict]:
        if self.conn is None:
            return None
        try:
            cur = self.conn.execute(
                "SELECT status, cost, error FROM score_cache WHERE "
                "signature=? AND shape=? AND mesh=? AND cid=?",
                (signature, shape, mesh, cid))
            row = cur.fetchone()
        except sqlite3.Error:
            return None
        if row is None:
            return None
        return {"status": row[0],
                "cost": json.loads(row[1]) if row[1] else None,
                "error": row[2]}

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
