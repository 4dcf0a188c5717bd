"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/torch_ext/`` at
the root of the checkout, then loaded with ``ctypes``.  No PyTorch header
is compiled, which keeps a build to seconds.  A library's file name holds
a digest of its sources and flags, so an edit never reuses a stale build.

Also home of the launch counts: every kernel wrapper adds one to its entry
in :data:`LAUNCHES` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"
SOURCES = {"flash_attention": "flash_attention.cu",
           "flash_decode": "flash_decode.cu",
           "rglru": "rglru.cu",
           "mlstm": "mlstm.cu",
           "rmsnorm": "rmsnorm.cu"}
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC")

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head_dim values the kernels are compiled for (REPRO_DISPATCH_D)
HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128, 256)
#: the mLSTM kernels' largest head dim, compiled into ``csrc/mlstm.cu``
MLSTM_MAX_DH = 512
#: each source's own ``-D`` flags
DEFINES = {"mlstm": (f"-DREPRO_MLSTM_MAX_DH={MLSTM_MAX_DH}",)}

#: one key per kernel op; flash-attention's backward kernel is in the
#: flash_attention source
LAUNCHES: Dict[str, int] = {name: 0 for name in (*SOURCES,
                                                 "flash_attention_bwd")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclass
class BuildResult:
    name: str
    path: Path
    log: str              # nvcc's output (ptxas statistics with verbose)
    seconds: float = 0.0  # this source's nvcc wall time (0 if cached)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str, flags) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, *,
          verbose: bool = False) -> Dict[str, BuildResult]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together.  Raises ``RuntimeError`` with nvcc's output if a
    build fails."""
    names = list(names or SOURCES)
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    results: Dict[str, BuildResult] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name, NVCC_FLAGS + DEFINES.get(name, ()))
        if out.exists() and not verbose:
            results[name] = BuildResult(name, out, "")
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *flags, *DEFINES.get(name, ()), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    # each process's output is drained on its own thread, so each finish
    # time is its own and no pipe fills up
    with ThreadPoolExecutor(max(1, len(procs))) as pool:
        done = {name: pool.submit(_finish, proc, t0)
                for name, (proc, _, _) in procs.items()}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, seconds = done[name].result()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, log, seconds)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


def _finish(proc, t0):
    log = proc.communicate()[0].strip()
    return log, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """A C entry point of kernel ``name``, typed once and cached.

    ``argtypes`` must name ``c_void_p`` for every pointer and the stream,
    or ctypes would pass them as 32-bit ints."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = restype
        fn.argtypes = argtypes
        _FNS[key] = fn
    return fn


# The launch path's device and stream queries, as plain ints: the public
# ``torch.cuda.current_stream`` builds a Stream object on every call.  A
# build of torch without CUDA has neither (and launches nothing).
_get_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_SAME_DEVICE = contextlib.nullcontext()


def on_device(device):
    """Make ``device`` current for a launch, unless it already is."""
    idx = device.index
    if idx is None or idx == (_get_device or torch.cuda.current_device)():
        return _SAME_DEVICE
    return torch.cuda.device(idx)


def check(name: str, code: int):
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        err = getattr(load(name), f"repro_{name}_error")
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({err(code).decode()})")


def check_dtype(name: str, dtype: torch.dtype, dtypes=tuple(DTYPE_CODES)):
    """Refuse a dtype the kernel is not compiled for."""
    if dtype not in dtypes:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"({sorted(map(str, dtypes))})")


def check_head_dim(name: str, head_dim: int, head_dims):
    """Refuse a head dim the kernel is not compiled for."""
    if head_dim not in head_dims:
        raise ValueError(f"{name}: head_dim {head_dim} not compiled "
                         f"(have {head_dims})")


def validate(name: str, tensors, *, dtypes=tuple(DTYPE_CODES),
             head_dims=HEAD_DIMS):
    """Common checks before a launch: CUDA, one device, a dtype of
    ``dtypes``, a contiguous last axis and, unless ``head_dims`` is None, a
    last axis (head_dim) the kernel is compiled for.  Devices are compared
    by index (``get_device``), without building device objects."""
    t0 = tensors[0]
    if not t0.is_cuda:
        raise ValueError(f"{name}: tensors must be on a CUDA device, got "
                         f"{t0.device}")
    dtype = t0.dtype
    check_dtype(name, dtype, dtypes)
    dev = t0.get_device()
    for t in tensors:
        if t.dtype != dtype or t.get_device() != dev:
            raise ValueError(f"{name}: mixed devices/dtypes "
                             f"{[(x.device, x.dtype) for x in tensors]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous, "
                             f"strides {t.stride()}")
    if head_dims is not None:
        check_head_dim(name, t0.shape[-1], head_dims)


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an int (``c_void_p`` in
    the entry points' argtypes)."""
    idx = device.index
    if idx is None:
        idx = (_get_device or torch.cuda.current_device)()
    if _raw_stream is not None:
        return _raw_stream(idx)
    return torch.cuda.current_stream(idx).cuda_stream


def strides_arg(*tensors_dims) -> ctypes.Array:
    """Pack (tensor, dims) pairs into one int64 array of element strides."""
    vals = [t.stride(d) for t, dims in tensors_dims for d in dims]
    return (ctypes.c_int64 * len(vals))(*vals)
