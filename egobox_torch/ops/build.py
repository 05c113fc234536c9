"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C
interface, at first use, and loaded with ctypes. The library lands in
``build/egobox_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import: the package imports on hosts
without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egobox_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each kernel entry point: (argtypes); every one returns a
#: cudaError_t as int
_SIGNATURES = {
    # kind, x1, x2, thw, out, sums, n1, n2, d, symmetric, stream
    "egx_corr_tile": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # a, out, m, b, stamps, stream
    "egx_factor_panel": (_P, _P, _I, _I, _P, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "egobox_torch can only be built on a host with the CUDA toolkit"
    )


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library and return its path.
    ``force`` rebuilds even when a library for these sources exists. The
    compiler's resource report (``-Xptxas -v``) is kept beside the library
    as ``<name>.log``."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libegobox_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists() and not force:
        return lib_path
    # compile to a temporary name, then rename: concurrent builders never
    # load a half-written library
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in sources:
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = [proc.communicate()[0] for _, _, proc in jobs]
        for (cmd, _, proc), out in zip(jobs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        tmp = Path(tmpdir) / lib_path.name
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        lib_path.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
