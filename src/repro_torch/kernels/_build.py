"""Build the port's CUDA kernels with ``nvcc`` at first use; bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``build/repro_torch_kernels/
<name>-<hash>.so`` at the repository root (a directory ``.gitignore`` lists),
keyed by a hash of the source, the shared headers and the flags, so an edit
rebuilds and an unchanged source loads the library already built.  The
sources have a plain C interface (no PyTorch headers), which keeps a build at
seconds; :func:`build` starts one ``nvcc`` per stale source, all at once.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch.  :func:`launch` raises on a
non-zero return and otherwise adds one to the kernel's launch count — the
only place the counts grow, so they show which kernels really ran.  The
helpers a wrapper calls on every launch (:func:`launch`, :func:`check_operand`,
:func:`stream_of`, :func:`on_device`) keep their common case short: a small
gather spends more time in them than on the card.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
#: source name -> {C function: argtypes}.  Pointers and the stream are
#: c_void_p: ctypes would otherwise pass a Python int as a 32-bit int.
SIGNATURES = {
    "sr_round": {
        # w, step, noise, out, rows, cols, lo, hi, stream
        "sr_round_launch": (_P, _P, _P, _P, _I64, _I64, _I, _I, _P),
        # w, step, out, rows, cols, lo, hi, seed (uint32), stream
        "sr_round_seeded_launch": (_P, _P, _P, _I64, _I64, _I, _I, ctypes.c_uint32, _P),
    },
    "dequant_gather": {
        # codes, step, ids, out, n, d, b, stream
        "dequant_gather_launch": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
        # packed, step, ids, out, n, d, b, bits, stream
        "dequant_gather_packed_launch": (_P, _P, _P, _P, _I64, _I64, _I64, _I, _P),
    },
    "sparse_row_update": {
        # codes, step, mu, nu, uniq, g_sum, noise, w_new, n, d, k, width,
        # container_bits, bits, lr, c1, c2, b1, 1-b1, b2, 1-b2, eps, wd, stream
        "sparse_row_update_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                     _I, _I, *(_F,) * 9, _P),
        # codes, step, mu, nu, uniq, g_occ, order (int64), starts, noise, w_new,
        # n, d, k, m, width, container_bits, bits, lr, c1, c2, b1, 1-b1, b2, 1-b2,
        # eps, wd, stream
        "sparse_row_update_runs_launch": (*(_P,) * 10, *(_I64,) * 5, _I, _I, *(_F,) * 9, _P),
    },
    "lpt_update": {
        # codes, step, new_step, upd, noise, out, rows, cols, width,
        # container_bits, bits, lr, wd, stream
        "lpt_update_launch": (*(_P,) * 6, _I64, _I64, _I64, _I, _I, _F, _F, _P),
    },
    "dequant_matmul": {
        # x, codes, step, y, M, N, K, bits (8: int8 codes; 4, 2: packed), stream
        "dequant_matmul_launch": (_P, _P, _P, _P, _I64, _I64, _I64, _I, _P),
    },
    "flash_attention": {
        # q, k, v, o, B, T, S, H, KH, D, causal, window (0: none), scale, stream
        "flash_attention_fwd_launch": (_P, _P, _P, _P, *(_I,) * 8, _F, _P),
    },
    "adam_update": {
        # count, 7*count tensor pointers, count sizes, lr, bc1, bc2, b1, 1-b1,
        # b2, 1-b2, eps, wd, stream
        "adam_update_launch": (_I, _P, _P, *(_F,) * 9, _P),
    },
}

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
#: (source, C function) -> the bound function, filled on first launch.
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, pathlib.Path]:
    """Compile every stale source in parallel; returns name -> library path."""
    names = tuple(SIGNATURES) if names is None else tuple(names)
    paths = {name: _library_path(name) for name in names}
    stale = {name: p for name, p in paths.items() if not p.exists()}
    if not stale:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in stale.items():
        # Build under a private name and rename into place: concurrent
        # builders of one source never see each other's half-written file.
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, stale[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check_operand(kernel: str, name: str, t, dtype, shape: tuple, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape
    (on ``device`` when given): the kernels take raw pointers and trust them.
    Each condition is tested once; a message is built only on failure."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        fault = f"must be a CUDA tensor, got {getattr(t, 'device', type(t).__name__)}"
    elif device is not None and t.device != device:
        fault = f"is on {t.device}, expected {device}"
    elif t.dtype != dtype:
        fault = f"must be {dtype}, got {t.dtype}"
    elif t.shape != shape:
        fault = f"must have shape {tuple(shape)}, got {tuple(t.shape)}"
    elif not t.is_contiguous():
        fault = "must be contiguous"
    else:
        return
    raise ValueError(f"{kernel}: {name} {fault}")


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, read without
    building a ``torch.cuda.Stream`` object."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(device):
    """A context that makes ``device`` current for a launch, or does nothing
    when it already is (the usual case: one card)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(kernel: str, source: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` of ``source``; raise on a CUDA error, else count."""
    bound = _FNS.get((source, fn))
    if bound is None:
        bound = _FNS[(source, fn)] = getattr(library(source), fn)
    err = bound(*args)
    if err != 0:
        msg = library(source).repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    LAUNCHES.clear()
