"""Point-level lint rules: one sweep point, nothing run, as the reference's
``src/repro/analysis/rules.py``.

Every rule mirrors a failure (or degradation) site of the port; the ids
the two packages share keep the reference's ids, severities and evidence:

``microbatch``    ``timer._with_microbatches`` raises when the global
                  batch is not divisible by ``knobs.microbatches``, and
                  training wraps EVERY segment in it.             [error]
``trace``         the abstract trace (the segment program run on fake
                  tensors, as the dry run runs it, in place of the
                  reference's ``jax.eval_shape``) raised; the real run
                  raises too.  Gated by ``trace=True``.           [error]
``chunk-clamp``   the plain mLSTM path (``kernels.ref.
                  mlstm_chunkwise_ref``) silently walks its chunk down to
                  a divisor of the sequence: the swept value is not the
                  executed value.  The reference lints the clamp on its
                  Pallas path; the port's ``cuda`` kernel ignores the
                  chunk (its own 64-row chunks), and neither port path of
                  RG-LRU takes a chunk, so here the site is the ``plain``
                  mLSTM path.                                      [warn]
``attn-chunk-fallback``  ``chunked_attention`` silently falls back to
                  naive full-matrix attention when the q-chunk does not
                  divide the sequence (``models/attention.py:71-72``).
                                                                   [warn]
``dtype-flow``    low-precision accumulation hazards: bf16 optimizer
                  state under ``opt_state_dtype``, bf16 KV-cache reads
                  with ``cache_upcast=False``.                     [warn]

The reference's ``attn-tile`` and ``decode-tile`` model Pallas tile
asserts, which the port's CUDA kernels do not have (they mask ragged
tiles).  For ``kernel="cuda"`` the ERROR rules are instead the refusals
of the port's kernel wrappers: each rule calls the check the wrapper
itself calls before a launch, on the sizes, dtype and strides of the
tensors the models pass, so the diagnostic's message is the raise's:

``cuda-dtype``    ``kernels/build.py:187`` (``check_dtype``, from
                  ``validate``): the attention kernels take f32 and bf16
                  only.                                           [error]
``cuda-head-dim`` ``kernels/build.py:194`` (``check_head_dim``, from
                  ``validate``): a head dim the attention kernels are not
                  compiled for.                                   [error]
``cuda-kv-heads`` ``kernels/flash_attention.py:46`` and
                  ``kernels/flash_decode.py:28`` (``check_heads``): query heads
                  not a multiple of the kv heads.                 [error]
``cuda-align``    ``kernels/flash_attention.py:58`` (``tma_strides``:
                  TMA needs 16-byte strides on the ``wgmma`` route) and
                  ``kernels/flash_decode.py:37`` (``check_rows``: 16-byte
                  rows): the strides of the views the models pass. [error]
``cuda-mlstm-dh`` ``kernels/mlstm.py:41`` (``check_head_dim``): a head dim
                  above the mLSTM kernels' ``MAX_DH``, which the build
                  compiles into ``csrc/mlstm.cu``.                [error]

A config cannot reach the wrappers' other refusals: a tensor off the card
or not contiguous in its last axis, mixed dtypes (``validate``), q, k and
v shapes (the models build k and v from one spec), a base address off 16
bytes (the caching allocator aligns every block), flash-decode's
``pos < 0``, and rglru's (the models hand the scan two contiguous (B,S,dr)
f32 arrays), so no rule predicts them.

The mesh rules, as the reference's:

``mesh-devices``  a swept MeshSpec point this process cannot materialize
                  (``MeshSpec.check_local``: a default group of another
                  world size).  Gated by ``check_devices``.       [error]
``shard-fallback``  a logical axis whose mapped mesh axes do not divide
                  its dim: silently replicated.                    [warn]

A rule of the reference with no site in the port:

``donate-unshaped``  PyTorch has no buffer donation.  ``GlobalKnobs.
                  donate`` reaches no program of the port: the train step
                  updates the parameters in place whatever it says
                  (``train/step.py``), and the segment programs ignore it
                  (``core/segment.py`` still counts it relevant, so row
                  and effective ids stay the reference's).  No donated
                  buffer can fail to alias, so the rule never fires; the
                  abstract trace it shared with ``trace`` runs as above.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.diagnostics import ERROR, WARN, Diagnostic
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.meshspec import MeshSpec, MeshUnsatisfiable
from repro_torch.core.segment import Segment, fragment
from repro_torch.runtime.sharding import Rules, mesh_axis_sizes


def _logical_dims(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, int]:
    """Canonical tensor dim per logical axis name: what the provider
    mappings are resolved against without a concrete tensor."""
    return {
        "batch": shape.global_batch,
        "seq": shape.seq_len,
        "kv_seq": shape.seq_len,
        "embed": cfg.d_model,
        "vocab": cfg.vocab_size,
        "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads,
        "ffn": cfg.d_ff,
        "expert_ffn": cfg.d_ff,
        "experts": cfg.num_experts,
        "rnn": int(cfg.expand_factor * cfg.d_model),
    }


def resolver(mapping: Dict[str, object], axis_sizes: Dict[str, int]):
    """A ``Rules`` resolving against declarative axis sizes, no live mesh:
    the production resolution itself."""
    r = Rules(mapping, None)
    r.axis_sizes = dict(axis_sizes)
    return r


def residual_pspec(cfg: ArchConfig, shape: ShapeConfig, combo: Combination,
                   seg: Segment, axis_sizes: Dict[str, int]):
    """The resolved partition of the residual stream entering/leaving
    ``seg`` under ``combo``: the cross-segment boundary contract."""
    from repro_torch.core.providers import get_provider
    mapping = get_provider(combo.provider).mapping(
        cfg, axis_sizes, combo.flags, seg)
    r = resolver(mapping, axis_sizes)
    if shape.kind == "decode":
        axes = ("batch", "embed")
        dims = (shape.global_batch, cfg.d_model)
    else:
        axes = ("batch", "seq", "embed")
        dims = (shape.global_batch, shape.seq_len, cfg.d_model)
    return tuple(r.pspec(axes, dims))


def _rule_mesh_devices(mesh) -> List[Diagnostic]:
    if not isinstance(mesh, MeshSpec) or mesh.is_local:
        return []
    try:
        mesh.check_local()
    except MeshUnsatisfiable as e:
        return [Diagnostic(
            "mesh-devices", ERROR, str(e),
            evidence={"mesh": mesh.key(), "needs": mesh.n_devices})]
    return []


def _rule_shard_fallback(cfg, shape, combo, seg,
                         axis_sizes) -> List[Diagnostic]:
    if not axis_sizes:
        return []
    from repro_torch.core.providers import get_provider
    mapping = get_provider(combo.provider).mapping(
        cfg, axis_sizes, combo.flags, seg)
    r = resolver(mapping, axis_sizes)
    dims = _logical_dims(cfg, shape)
    out: List[Diagnostic] = []
    for name, cands in sorted(r.mapping.items()):
        if cands[0] is None or name not in dims:
            continue
        # only a divisibility fallback is news: a candidate whose axes
        # are absent from this mesh is structural
        reachable = []
        for cand in cands:
            if cand is None:
                continue
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            axes = tuple(a for a in axes if a in axis_sizes)
            if axes:
                reachable.append(axes)
        if not reachable:
            continue
        dim = dims[name]
        if r._resolve_one(name, dim, set()) is None:
            out.append(Diagnostic(
                "shard-fallback", WARN,
                f"logical axis {name!r} (dim {dim}) not divisible by "
                f"its mapped mesh axes {reachable[0]!r} under mesh "
                f"{axis_sizes}: silently replicated",
                segment=seg.name,
                evidence={"axis": name, "dim": dim,
                          "mesh": dict(axis_sizes)}))
    return out


def _clamp_chunk(chunk: int, S: int) -> int:
    c = min(int(chunk), S)
    while S % c:
        c -= 1
    return c


def _first_refusal(checks) -> List[Diagnostic]:
    """Run ``(rule, check, evidence)`` in order; the first check that
    raises is the refusal, with the wrapper's own message."""
    for rule, check, evidence in checks:
        try:
            check()
        except (TypeError, ValueError) as e:
            return [Diagnostic(rule, ERROR, str(e), evidence=evidence)]
    return []


def _cuda_refusals(op: str, cfg: ArchConfig,
                   shape: ShapeConfig) -> List[Diagnostic]:
    """The first refusal the CUDA wrapper of ``op`` raises on the tensors
    the models (and ``kernels/autotune.py``'s op programs) pass it at
    ``(cfg, shape)``: the wrapper's own checks, in its order, on the sizes,
    dtype and strides of those tensors; [] if none."""
    import torch

    # the package's names flash_attention and flash_decode are the ops,
    # so the wrapper modules' checks are imported by name
    from repro_torch.kernels import build as K
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels.flash_attention import check_heads as fa_heads
    from repro_torch.kernels.flash_attention import route, tma_strides
    from repro_torch.kernels.flash_decode import check_heads as fd_heads
    from repro_torch.kernels.flash_decode import check_rows
    if op == "mlstm_chunkwise":
        dh = int(cfg.expand_factor * cfg.d_model) // cfg.num_heads
        return _first_refusal([("cuda-mlstm-dh",
                                lambda: ML.check_head_dim(dh),
                                dict(dh=dh, max_dh=ML.MAX_DH))])
    if op not in ("flash_attention", "flash_decode"):
        return []                         # rglru: no refusal reachable
    B, S = shape.global_batch, shape.seq_len
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dtype = getattr(torch, cfg.dtype)
    check_heads = fa_heads if op == "flash_attention" else fd_heads
    checks = [
        ("cuda-dtype", lambda: K.check_dtype(op, dtype),
         dict(dtype=cfg.dtype)),
        ("cuda-head-dim", lambda: K.check_head_dim(op, D, K.HEAD_DIMS),
         dict(head_dim=D)),
        ("cuda-kv-heads", lambda: check_heads(H, KV),
         dict(heads=H, kv_heads=KV))]
    if op == "flash_attention":
        # the (B,H,S,D) views of the (B,S,H,D) tensors; only the wgmma
        # route maps them with TMA (the FMA route takes any stride)
        views = {"q": ((B, H, S, D), (S * H * D, D, H * D, 1)),
                 "k": ((B, KV, S, D), (S * KV * D, D, KV * D, 1))}
        if route(dtype, D) == "wgmma":
            checks += [("cuda-align",
                        lambda v=v: tma_strides(*v, dtype.itemsize, D),
                        dict(tensor=name, strides=list(v[1][:3])))
                       for name, v in views.items()]
    else:
        # q (B,H,D) and the (B,KV,Smax,D) views of the (B,Smax,KV,D) caches
        views = {"q": (H * D, D, 1), "k": (S * KV * D, D, KV * D, 1)}
        checks += [("cuda-align", lambda st=st: check_rows(st),
                    dict(tensor=name, strides=list(st)))
                   for name, st in views.items()]
    return _first_refusal(checks)


# --- kernel-schedule subset (shared with kernels/autotune.py) ---------------

def lint_schedule(op: str, fields: Dict[str, object], cfg: ArchConfig,
                  shape: ShapeConfig) -> List[Diagnostic]:
    """Lint one (op, schedule) variant of the kernel autotuner's grid.

    The autotuner's op programs call the ops as the models do, so a
    ``cuda`` refusal here is the raise the program would die on: sound
    for the autotuner's rejection before it runs the variant."""
    out: List[Diagnostic] = []
    S = shape.seq_len
    kernel = fields.get("kernel", "plain")
    if kernel == "cuda":
        return _cuda_refusals(op, cfg, shape)
    if op == "flash_attention":
        bq = int(fields.get("block_q", 512))
        if S > bq and S % bq:
            out.append(Diagnostic(
                "attn-chunk-fallback", WARN,
                f"q_chunk {bq} does not divide seq_len {S}: "
                f"chunked_attention silently falls back to naive "
                f"full-matrix attention",
                evidence={"seq_len": S, "block_q": bq}))
    elif op == "mlstm_chunkwise":
        c = int(fields.get("mlstm_chunk", 256))
        eff = _clamp_chunk(c, S)
        if eff != min(c, S):
            out.append(Diagnostic(
                "chunk-clamp", WARN,
                f"mlstm_chunk {c} silently clamped to {eff} "
                f"(largest divisor of seq_len {S})",
                evidence={"seq_len": S, "mlstm_chunk": c, "effective": eff}))
    return out


# --- per-point rules --------------------------------------------------------

def _rule_microbatch(shape, knobs) -> List[Diagnostic]:
    if shape.kind != "train" or knobs is None:
        return []
    mb = knobs.microbatches
    if mb > 1 and shape.global_batch % mb:
        # _with_microbatches wraps every train segment program, so the
        # point fails on all of them: one global diagnostic
        return [Diagnostic(
            "microbatch", ERROR,
            f"global_batch {shape.global_batch} not divisible by "
            f"microbatches={mb}: the gradient-accumulation split raises",
            evidence={"global_batch": shape.global_batch,
                      "microbatches": mb})]
    return []


def _rule_tiles(cfg, shape, combo, seg) -> List[Diagnostic]:
    """The kernel-schedule rules at the segment's op sites (the models'
    dispatch: ``models/attention.py``, ``models/xlstm.py``)."""
    out: List[Diagnostic] = []
    if seg.kind != "stack":
        return out
    cl = combo.clause
    full_seq = shape.kind in ("train", "prefill")
    sites = []
    if seg.has_attn and full_seq:
        sites.append(("flash_attention", {"kernel": cl.kernel,
                                          "block_q": cl.block_q,
                                          "block_k": cl.block_k}))
    if seg.has_attn and shape.kind == "decode" and not cfg.window_size \
            and cl.kernel == "cuda":
        sites.append(("flash_decode", {"kernel": cl.kernel,
                                       "block_k": cl.block_k}))
    if "mlstm" in seg.pattern and full_seq:
        sites.append(("mlstm_chunkwise", {"kernel": cl.kernel,
                                          "mlstm_chunk": cl.mlstm_chunk}))
    for op, fields in sites:
        for d in lint_schedule(op, fields, cfg, shape):
            d.segment = seg.name
            if op == "flash_decode" and cl.decode_shardmap:
                # the shardmap gate (models/attention.py attn_decode) also
                # needs the cache's seq dim sharded, which the mesh decides:
                # the kernel is only maybe reached, not provably
                d.severity = WARN
                d.message += (" (decode_shardmap=True may bypass the "
                              "kernel; not provably fatal)")
            out.append(d)
    return out


def _rule_opt_dtype(shape, knobs) -> List[Diagnostic]:
    if shape.kind == "train" and knobs is not None \
            and knobs.opt_state_dtype == "bfloat16":
        return [Diagnostic(
            "dtype-flow", WARN,
            "opt_state_dtype=bfloat16: optimizer-state accumulation in "
            "bf16 loses small updates (~8 bits of mantissa)",
            evidence={"opt_state_dtype": knobs.opt_state_dtype})]
    return []


def _rule_dtype_flow(cfg, shape, combo, seg) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    if shape.kind == "decode" and seg.kind == "stack" and seg.has_attn \
            and not combo.clause.cache_upcast and cfg.dtype == "bfloat16":
        out.append(Diagnostic(
            "dtype-flow", WARN,
            "cache_upcast=False with a bfloat16 KV cache: attention "
            "logits accumulate in reduced precision",
            segment=seg.name,
            evidence={"dtype": cfg.dtype,
                      "cache_upcast": combo.clause.cache_upcast}))
    return out


def _rule_trace(cfg, shape, combo, knobs, seg) -> List[Diagnostic]:
    """Run the segment program on fake tensors (what the dry run does,
    no device memory, nothing computed); a failure is a sound *error*:
    the real program builds and runs identically."""
    if shape.kind != "train" or knobs is None:
        return []
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.timer import segment_program
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = segment_program(cfg, shape, seg, combo, device="cpu",
                                       knobs=knobs)
            fn(*args)
    except Exception as e:
        return [Diagnostic(
            "trace", ERROR,
            f"abstract trace failed: {type(e).__name__}: {e}",
            segment=seg.name,
            evidence={"exception": type(e).__name__})]
    return []


# --- entry point ------------------------------------------------------------

def analyze_point(cfg: ArchConfig, shape: ShapeConfig, combo: Combination,
                  knobs: Optional[GlobalKnobs] = None, mesh=None,
                  segments: Optional[Sequence[Segment]] = None, *,
                  check_devices: bool = False,
                  trace: bool = False) -> List[Diagnostic]:
    """Lint one sweep point without running it.

    ``mesh`` is a :class:`MeshSpec` (a swept point), a live
    ``DeviceMesh`` (a fixed mesh) or ``None``; ``check_devices`` enables
    the process-local mesh check (meaningful only where the linting
    process is the scoring one).  ``segments`` defaults to every segment of ``cfg`` (pass
    one to lint a single scheduler row).  ``trace`` enables the
    abstract-trace rule: cheap per point at smoke size but not free, so
    the scheduler's bulk path leaves it off and the plan lint turns it on.

    Returns structured :class:`Diagnostic` records, errors first.
    """
    segs = list(segments) if segments is not None else list(fragment(cfg))
    axis_sizes = mesh_axis_sizes(mesh)
    diags: List[Diagnostic] = []
    diags += _rule_microbatch(shape, knobs)
    diags += _rule_opt_dtype(shape, knobs)
    if check_devices:
        diags += _rule_mesh_devices(mesh)
    for seg in segs:
        diags += _rule_tiles(cfg, shape, combo, seg)
        diags += _rule_shard_fallback(cfg, shape, combo, seg, axis_sizes)
        diags += _rule_dtype_flow(cfg, shape, combo, seg)
        if trace:
            diags += _rule_trace(cfg, shape, combo, knobs, seg)
    diags.sort(key=lambda d: (d.severity != ERROR,))
    return diags
