"""Native (C++) runtime components, loaded via ctypes (port of
egobox_tpu/native, with its own copy of ``nelder_mead.cpp``).

The shared library is host C++, built with ``g++ -O2 -shared -fPIC
-std=c++17`` at first use into ``build/egobox_torch/`` at the root of the
checkout (beside the CUDA kernels' library, ops/build.py), named by a hash
of the source and the flags: a changed source is rebuilt, an unchanged one
loaded as it is. Nothing is built at import. A plain C ABI with ctypes keeps
the binding free of any extension framework.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..ops.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "nelder_mead.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None

_OBJFN = ctypes.CFUNCTYPE(
    ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ctypes.c_void_p,
)


def build(force: bool = False) -> Path:
    """Compile ``nelder_mead.cpp`` and return the library's path; a failed
    compile raises with the compiler's output."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libegx_native_{digest.hexdigest()[:16]}.so"
    if lib_path.exists() and not force:
        return lib_path
    # compile to a temporary name, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / lib_path.name
        cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ not runnable: {' '.join(cmd)}: {e}") \
                from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def load():
    """The bound library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.egx_nelder_mead.restype = ctypes.c_int
            lib.egx_nelder_mead.argtypes = [
                _OBJFN, ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
    return _lib


def nelder_mead(fun, x0, lower, upper, max_eval: int = 1000,
                xatol: float = 1e-8, fatol: float = 1e-10):
    """Minimize ``fun(x) -> float`` (x a float64 numpy vector) over the box
    [lower, upper] with the native derivative-free simplex solver. Returns
    (x, f, n_evals). An exception raised by ``fun`` ends the solve and is
    raised again once the C call has returned."""
    lib = load()
    x = np.ascontiguousarray(np.asarray(x0, dtype=np.float64)).copy()
    lo = np.ascontiguousarray(np.asarray(lower, dtype=np.float64))
    hi = np.ascontiguousarray(np.asarray(upper, dtype=np.float64))
    n = x.shape[0]
    if lo.shape[0] != n or hi.shape[0] != n:
        raise ValueError("bound shapes must match x0")

    err_holder = []

    @_OBJFN
    def cb(px, nn, _user):
        try:
            xi = np.ctypeslib.as_array(px, shape=(nn,))
            return float(fun(xi.copy()))
        except Exception as e:  # noqa: BLE001 — must not unwind into C
            err_holder.append(e)
            return 1e300

    fmin = ctypes.c_double(0.0)
    n_evals = lib.egx_nelder_mead(
        cb, None, n,
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(max_eval), float(xatol), float(fatol), ctypes.byref(fmin),
    )
    if err_holder:
        raise err_holder[0]
    if n_evals < 0:
        raise RuntimeError("egx_nelder_mead: invalid input")
    return x, float(fmin.value), int(n_evals)


def minimize_dfo_constrained(fun, cstrs, x0, lower, upper,
                             max_eval: int = 1000, n_penalty_rounds: int = 4):
    """Derivative-free constrained minimization: adaptive quadratic penalty
    around the native simplex solver (the COBYLA usage pattern of the
    reference: fun + inequality constraints g_i(x) <= 0)."""
    x = np.asarray(x0, dtype=np.float64).copy()
    mu = 10.0
    budget = max(max_eval // max(n_penalty_rounds, 1), 10)
    f = np.inf
    for _ in range(max(n_penalty_rounds, 1)):
        def penalized(xx, _mu=mu):
            viol = np.array([max(0.0, float(c(xx))) for c in cstrs])
            return float(fun(xx)) + 0.5 * _mu * float(np.sum(viol**2))

        x, f, _ = nelder_mead(penalized, x, lower, upper, max_eval=budget)
        mu *= 10.0
        if not cstrs:
            break
    return x, f


__all__ = ["build", "load", "minimize_dfo_constrained", "nelder_mead"]
