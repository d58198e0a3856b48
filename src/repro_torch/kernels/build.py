"""Build, load and launch the port's CUDA kernels (``kernels/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds, not minutes.  The sources are
compiled in parallel, at first use, into
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed on a hash
of every file under ``csrc/`` and the compiler flags; a finished build is
reused.  Nothing here runs at import time: the CPU tests import every module
of the package on a machine without ``nvcc``.

:func:`launch` is the one place a kernel is launched.  It passes every
pointer as ``c_void_p``, launches on the operands' device and that device's
current PyTorch stream, raises when
the C entry point returns a non-zero ``cudaGetLastError()`` code, and only
then adds one to that kernel's count in :data:`LAUNCHES`, to the count of
the template instantiation it ran in :data:`VARIANTS` (each C entry point
reports it through its ``int* variant`` out-argument) and to the count of
its integer arguments in :data:`CALLS`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> C argument types (pointers, the variant out-argument and the
# stream as c_void_p; the last two are always the variant and the stream)
SIGNATURES = {
    "lowrank_update": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P, _P),
    "back_project": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "back_project_epilogue": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P),
    "gram": (_P, _P, _I, _I, _I, _P, _P),
    "poly_apply": (_P, _P, _P, _I, _I, _I, _F, _P, _P),
    "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P),
    "ssd_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
}
KERNELS = tuple(SIGNATURES)
VARIANT_LEN = 8  # csrc/tf32x3.cuh

# Launches per kernel since the last reset_launches(); only launch() adds.
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
# Launches per kernel and template instantiation since the last
# reset_launches(): {name: {template arguments: launches}}, the arguments in
# the kernel's template order, bools as 0 / 1 (e.g. back_project (64, 64,
# 1, 1): a 64 x 64 tile, P read K-major on the right side, 16-byte copies).
VARIANTS: dict[str, dict[tuple[int, ...], int]] = {name: {} for name in KERNELS}
# Launches per kernel and integer arguments since the last reset_launches():
# {name: {the C entry's int arguments in order: launches}}, e.g.
# flash_attention (B, S, T, H, KV, D, causal, element type).
CALLS: dict[str, dict[tuple[int, ...], int]] = {name: {} for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        VARIANTS[name] = {}
        CALLS[name] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every missing kernel library (all ``nvcc`` runs at once) and
    return ``{kernel name: .so path}``; each compiler log (with ptxas's
    register and spill report) lands beside its library as ``<name>.log``.
    Raises with the compiler's output when a build fails."""
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in KERNELS}
    todo = [name for name, so in libs.items() if not so.exists()]
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])  # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all of them on first use)."""
    if not _LIBS:
        for kname, so in build().items():
            lib = ctypes.CDLL(str(so))
            fn = getattr(lib, kname)
            fn.argtypes = list(SIGNATURES[kname])
            fn.restype = ctypes.c_int
            _LIBS[kname] = lib
    return _LIBS[name]


def tile(name: str, *args: int) -> tuple[int, int]:
    """The block tile (rows, columns of the output) that kernel ``name``
    picks for the integer arguments ``args``, read from its library's
    ``<name>_tile`` entry (which returns rows * 1000 + columns, 0 for
    arguments the kernel refuses); builds the kernels on first use and
    launches nothing."""
    fn = getattr(library(name), f"{name}_tile")
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    code = fn(*args)
    if code == 0:
        raise ValueError(f"{name}: no tile for arguments {args}")
    return divmod(code, 1000)


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device`` — the operands' device, made
    current for the launch whichever device is current outside — on that
    device's current stream, with C ``args`` (tensors pass their
    ``data_ptr()``; None passes a null pointer)."""
    fn = getattr(library(name), name)
    variant = (ctypes.c_int * VARIANT_LEN)(*([-1] * VARIANT_LEN))
    with torch.cuda.device(device):
        rc = fn(*args, ctypes.addressof(variant),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
    key = tuple(v for v in variant if v != -1)
    VARIANTS[name][key] = VARIANTS[name].get(key, 0) + 1
    ints = tuple(a for a, kind in zip(args, SIGNATURES[name]) if kind is _I)
    CALLS[name][ints] = CALLS[name].get(ints, 0) + 1


def check_operands(device: torch.device, *, ndim: int = 3, dtype_error=TypeError,
                   dtypes: tuple[torch.dtype, ...] = (torch.float32,), **tensors) -> None:
    """Raise unless every given tensor is a contiguous ``ndim``-D tensor of
    one of ``dtypes`` (fp32 alone by default) on the CUDA ``device`` (None
    entries are skipped: optional operands); a wrong dtype raises
    ``dtype_error``."""
    if device.type != "cuda":
        raise ValueError(f"CUDA kernels need CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise dtype_error(f"{name} must be one of {[str(d)[6:] for d in dtypes]}, "
                              f"got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
