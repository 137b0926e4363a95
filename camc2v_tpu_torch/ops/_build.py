"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `_build/lib<name>-<hash>.so` inside this package (listed in
.gitignore), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source files, so an edited kernel rebuilds. `build_all()`
compiles every kernel in parallel and returns the wall time; `load(name)`
builds one kernel if needed and returns its `ctypes.CDLL` for a launch
(`function(name, symbol, argtypes)` returns an entry point with its types
set once), and raises in grad mode: a ctypes launch writes a fresh tensor
that autograd does not see, so kernels launch only inside their
`torch.autograd.Function` (whose forward and backward run with grad mode
off) or under `torch.no_grad()`. Nothing here runs at import: the CPU
tests import every module, and a machine without the CUDA toolkit has no
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("groupnorm", "flash_attention", "temporal_attention", "geglu_ff", "epipolar_flash", "flash_bwd",
           "epipolar_bwd", "layernorm", "groupnorm_twophase", "epipolar_precomp")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=KERNELS) -> float:
    """Compile every kernel not yet built, in parallel; returns seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    if torch.is_grad_enabled():
        raise RuntimeError(f"{name}: a kernel launch in grad mode would cut the autograd graph; launch it "
                           "through its autograd.Function (the wrappers do) or under torch.no_grad()")
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of kernel `name` (through `load`, so with
    its grad-mode check), its `restype` (int) and `argtypes` set once, when
    the library is first loaded."""
    lib = load(name)
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on the CUDA error code a kernel's C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
