"""Continuous-batching decode engine: overlapping requests, one program.

The engine serves requests from a fixed-capacity batched decode step
(slot = batch row).  Scheduling is iteration-level: every engine step runs
ONE batched ``decode_step`` with a per-slot position vector, new requests
are admitted into free slots between steps, and a slot is recycled the
moment its request finishes (EOS or max-tokens).

Admission prefills the request alone (``make_prefill_cache``: the plan's
decode step looped over the prompt at a scalar position, which is the path
of the flash-decode kernel under a ``"cuda"`` clause) and copies the filled
cache rows into the batch at the slot, in place.

**Byte-identity contract.**  Row ``b`` of every batched op here is a
function of row ``b``'s inputs alone, and the batched step always runs at
the full capacity, so every matrix product has the same shape whatever the
occupancy.  A request's token stream in a continuously batched run is
therefore byte-identical to the same request served alone, and
``run(requests, max_active=1)`` is the sequential baseline on the very
same step.

**MoE archs.**  An MoE FFN routes the batch's tokens together, and a
token past its expert's capacity ``C`` is dropped, so in general a row
depends on its neighbours (the engine logs the reference's warning).
Without a mesh the contract still holds whenever the batch's tokens fit
every expert's capacity, that is when the slot count is at most
``C = capacity(cfg, slots)``: a token's top-k experts are distinct, so no
expert receives more than ``slots`` tokens, none is dropped, and the
combine sums each row's own terms in a fixed order (no atomics).  For
qwen3-moe-30b-a3b at 8 slots, C = max(8, min(int(1.25 * 8 * 8 / 128), 8))
= 8; admission (one row) always fits.

**Under a mesh** (``mesh=``, a ``DeviceMesh`` over the default group,
the reference's ``ServeEngine(..., mesh=)``) every rank runs the same
engine on the same requests: the params and the caches are DTensors
placed by the plan's rules (``train.step.param_shardings``,
``serve.step.cache_shardings``), each step's tokens come back gathered,
and admission writes a slot through the caches' global value.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Plan
from repro_torch.device import resolve_device
from repro_torch.models.blocks import ATTN_KINDS, block_cache_spec
from repro_torch.core.plan import segment_rules
from repro_torch.models.model import init_cache, model_specs
from repro_torch.models.params import (init_params, place_params, tree_leaves,
                                       tree_map)
from repro_torch.runtime.sharding import local_range
from repro_torch.serve.step import (make_decode_step, make_prefill_cache,
                                    place_caches)

log = logging.getLogger("repro_torch.serve")


@dataclass(frozen=True)
class Request:
    """One generation request."""
    rid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           tuple(int(t) for t in self.prompt))
        if not self.prompt:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid!r}: max_new_tokens "
                             f"{self.max_new_tokens} < 1")


@dataclass
class Completion:
    """A finished request's stream and bookkeeping."""
    rid: str
    prompt_len: int
    tokens: List[int]               # generated tokens, prompt excluded
    finish_reason: str              # "eos" | "length"
    slot: int
    admitted_step: int              # engine step at admission
    done_step: int


@dataclass
class ServeStats:
    """Counters of one ``run()``.  ``prefill_s`` and ``decode_s`` are host
    clock spans that end in a device sync (each admission reads its first
    token, each step its next tokens)."""
    capacity: int = 0
    n_admitted: int = 0
    n_completed: int = 0
    n_steps: int = 0                # batched decode steps
    n_prefills: int = 0
    n_prefill_tokens: int = 0
    n_tokens: int = 0               # generated tokens
    occupancy_sum: float = 0.0      # sum over steps of active/capacity
    peak_active: int = 0
    elapsed_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def occupancy(self) -> float:
        """Mean slot occupancy over the batched decode steps."""
        return self.occupancy_sum / self.n_steps if self.n_steps else 0.0

    @property
    def tok_s(self) -> float:
        return self.n_tokens / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.n_prefill_tokens / self.prefill_s if self.prefill_s \
            else 0.0

    @property
    def decode_tok_s(self) -> float:
        """Tokens generated by the batched steps per second of them."""
        n = self.n_tokens - self.n_prefills
        return n / self.decode_s if self.decode_s else 0.0

    def summary(self) -> str:
        return (f"capacity={self.capacity} admitted={self.n_admitted} "
                f"completed={self.n_completed} steps={self.n_steps} "
                f"prefills={self.n_prefills} "
                f"prefill_tokens={self.n_prefill_tokens} "
                f"tokens={self.n_tokens} occupancy={self.occupancy:.2f} "
                f"peak_active={self.peak_active} "
                f"elapsed={self.elapsed_s:.2f}s tok_s={self.tok_s:.1f}")


@dataclass
class _Slot:
    req: Request
    generated: List[int]
    admitted_step: int


def cache_batch_axes(cfg: ArchConfig):
    """Per-leaf slot-axis index of the decode cache tree.

    Unstacked groups carry the batch on axis 0; stacked groups
    (``repeats > 1``) carry layers on axis 0 and the batch on axis 1.
    """
    axes = {}
    for gi, group in enumerate(cfg.stack_plan()):
        ax = 1 if group.repeats > 1 else 0
        g = {}
        for j, kind in enumerate(group.pattern):
            g[f"b{j}"] = tree_map(lambda _: ax,
                                  block_cache_spec(kind, cfg, 1, 1))
        axes[f"g{gi}"] = g
    return axes


def _put_row(caches, filled, axes, s: int):
    """Copy a B=1 cache tree into slot ``s`` of the batch tree, in place.
    Under a mesh each leaf's B=1 row takes the leaf's layout on its other
    dims, and the rank whose shard holds slot ``s`` copies it there."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def put(c, f, ax):
        at = (slice(None),) * ax
        if not isinstance(c, DTensor):
            c[at + (s,)].copy_(f[at + (0,)])
            return
        mesh = c.device_mesh
        if not isinstance(f, DTensor):
            f = DTensor.from_local(f, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        f = f.redistribute(mesh, [Replicate() if isinstance(p, Shard)
                                  and p.dim == ax else p
                                  for p in c.placements])
        lo, hi = local_range(c, ax)
        if lo <= s < hi:
            c.to_local()[at + (s - lo,)].copy_(f.to_local()[at + (0,)])
    tree_map(put, caches, filled, axes)
    return caches


class ServeEngine:
    """Fixed-capacity continuous batching over one batched decode step.

    ``capacity`` is the slot count (the batch), ``cache_len`` the per-slot
    sequence budget: every request must satisfy
    ``len(prompt) + max_new_tokens <= cache_len`` (windowed and recurrent
    archs are exempt: their caches ring-wrap or hold fixed-size state).
    Decoding is greedy.
    """

    def __init__(self, cfg: ArchConfig, plan: Plan, *, capacity: int = 4,
                 cache_len: int = 64, mesh=None, params=None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        if cfg.is_moe:
            log.warning(
                "%s is MoE: expert routing mixes rows across the batch, "
                "so the batched-equals-sequential byte-identity contract "
                "does not hold (streams may differ by routing pressure)",
                cfg.name)
        self.cfg, self.plan = cfg, plan
        self.capacity, self.cache_len = int(capacity), int(cache_len)
        self._step = make_decode_step(cfg, plan, device=self.device,
                                      mesh=mesh)
        self._prefill = make_prefill_cache(cfg, plan, device=self.device,
                                           mesh=mesh)
        if params is None:
            params = init_params(model_specs(cfg),
                                 torch.Generator().manual_seed(seed),
                                 self.device)
        if mesh is not None and not any(
                hasattr(t, "device_mesh") for t in tree_leaves(params)):
            params = place_params(params, model_specs(cfg),
                                  segment_rules(cfg, plan, mesh))
        self.params = params
        self._axes = cache_batch_axes(cfg)
        # only full-causal KV caches bound a request's length; windowed
        # caches ring-wrap and recurrent state has no length
        self._bounded_cache = not cfg.window_size and any(
            k in ATTN_KINDS for k in cfg.block_kinds())
        self.stats = ServeStats(capacity=self.capacity)

    # ------------------------------------------------------------------
    def run(self, requests: Sequence, *,
            max_active: Optional[int] = None) -> Dict[str, Completion]:
        """Serve every request to completion; returns rid -> Completion.

        ``max_active`` throttles admission below the slot capacity;
        ``max_active=1`` is the sequential one-request-at-a-time baseline
        on the same batched step.
        """
        reqs = [r if isinstance(r, Request) else Request(**r)
                for r in requests]
        rids = [r.rid for r in reqs]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate request ids: {rids}")
        if self._bounded_cache:
            for r in reqs:
                need = len(r.prompt) + r.max_new_tokens
                if need > self.cache_len:
                    raise ValueError(
                        f"request {r.rid!r} needs {need} cache slots "
                        f"(prompt {len(r.prompt)} + {r.max_new_tokens} "
                        f"new) > cache_len={self.cache_len}")
        cap = self.capacity if max_active is None \
            else max(1, min(int(max_active), self.capacity))
        B = self.capacity
        queue = deque(reqs)
        slots: List[Optional[_Slot]] = [None] * B
        caches = self._fresh_cache(B)
        tokens = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        stats = self.stats = ServeStats(capacity=B)
        done: Dict[str, Completion] = {}
        step_i = 0
        t0 = time.perf_counter()
        while queue or any(s is not None for s in slots):
            # admission: fill free slots up to the active cap
            active = sum(s is not None for s in slots)
            for s in range(B):
                if not queue or active >= cap:
                    break
                if slots[s] is not None:
                    continue
                req = queue.popleft()
                caches, first = self._admit(caches, s, req, stats)
                slots[s] = _Slot(req, [first], step_i)
                tokens[s] = first
                pos[s] = len(req.prompt)
                active += 1
                # a 1-token request (or instant EOS) never enters the
                # batched step; its slot frees immediately
                if self._finish_if_done(slots, s, tokens, pos, done,
                                        stats, step_i):
                    active -= 1
            if not any(s is not None for s in slots):
                continue
            # one batched decode step, per-slot positions
            t_step = time.perf_counter()
            nxt, _, caches = self._step(
                self.params, caches,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(pos).to(self.device))
            nxt_np = nxt.cpu().numpy()
            stats.decode_s += time.perf_counter() - t_step
            step_i += 1
            n_act = sum(s is not None for s in slots)
            stats.n_steps += 1
            stats.occupancy_sum += n_act / B
            stats.peak_active = max(stats.peak_active, n_act)
            for s in range(B):
                sl = slots[s]
                if sl is None:
                    continue
                tok = int(nxt_np[s])
                sl.generated.append(tok)
                stats.n_tokens += 1
                tokens[s] = tok
                pos[s] += 1
                self._finish_if_done(slots, s, tokens, pos, done, stats,
                                     step_i)
        stats.elapsed_s = time.perf_counter() - t0
        return done

    # ------------------------------------------------------------------
    def _admit(self, caches, s: int, req: Request, stats: ServeStats):
        """Prefill ``req`` alone (B=1, fresh zero cache) and copy the
        filled rows into slot ``s``.  The fresh cache also clears whatever
        the previous occupant left in the slot (KV ring buffers, recurrent
        and conv state)."""
        t = time.perf_counter()
        prompt = torch.tensor([req.prompt], dtype=torch.int64,
                              device=self.device)
        fresh = self._fresh_cache(1)
        first, _, filled = self._prefill(self.params, fresh, prompt)
        caches = _put_row(caches, filled, self._axes, s)
        first = int(first[0])
        stats.prefill_s += time.perf_counter() - t
        stats.n_admitted += 1
        stats.n_prefills += 1
        stats.n_prefill_tokens += len(req.prompt)
        stats.n_tokens += 1                   # the prefill's first token
        return caches, first

    def _fresh_cache(self, batch: int):
        return place_caches(init_cache(self.cfg, batch, self.cache_len,
                                       self.device),
                            self.cfg, self.plan, self.mesh)

    @staticmethod
    def _finish_if_done(slots, s: int, tokens, pos, done, stats,
                        step_i: int) -> bool:
        sl = slots[s]
        req, tok = sl.req, sl.generated[-1]
        if req.eos_id is not None and tok == req.eos_id:
            reason = "eos"
        elif len(sl.generated) >= req.max_new_tokens:
            reason = "length"
        else:
            return False
        done[req.rid] = Completion(
            req.rid, len(req.prompt), list(sl.generated), reason, s,
            sl.admitted_step, step_i)
        slots[s] = None
        tokens[s] = 0
        pos[s] = 0
        stats.n_completed += 1
        return True
