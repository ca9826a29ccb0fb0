"""The native (C++) ``${fparse}`` evaluator, bound with ctypes.

The JAX package evaluates deck-level scalar expressions through a library
built from ``native/expr_eval.cpp`` and falls back to its Python engine
(marlin_tpu/native.py, marlin_tpu/expression.py:fparse).  The port builds
its own copy of that library from the same source, with
``g++ -O2 -shared -fPIC``, into ``marlin_tpu_torch/_build/`` (the kernels'
build directory): once, at first use, under a lock, to a file named by a
hash of the source, so a changed source builds anew and two processes
never load a half-written library.  It never runs the JAX package's
``make``.  The Python engine (``expression.parse``) stays the reference;
``expression.fparse`` takes the native value where the library loads.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

from . import perf

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "native", "expr_eval.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


class NativeError(Exception):
    pass


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"marlin_native_{digest}.so")


def build() -> str:
    """Compile the library unless it exists; returns its path.  A file
    lock in the build directory keeps two processes from building at
    once; the library is written to a temporary name and renamed.
    Raises NativeError with g++'s output where the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    if shutil.which("g++") is None:
        raise NativeError("g++ is not installed")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "marlin_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # built by another process meanwhile
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            with perf.span("kernels::build"):
                proc = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE],
                                      capture_output=True, text=True, timeout=300)
            perf.count("kernel_builds")
            if proc.returncode != 0:
                raise NativeError(f"g++ failed ({proc.returncode}):\n"
                                  f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call (None where it
    cannot be: no g++, no source, a failed build)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (NativeError, OSError, subprocess.SubprocessError):
            return None
        # the JAX package's signatures (marlin_tpu/native.py)
        lib.marlin_eval.restype = ctypes.c_double
        lib.marlin_eval.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.marlin_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def eval_scalar(expr: str, env: Optional[Dict[str, float]] = None) -> float:
    """``expr`` evaluated by the native engine over the variables ``env``.
    Raises NativeError where the library is missing or refuses the
    expression (the caller then takes the Python engine)."""
    lib = get_lib()
    if lib is None:
        raise NativeError("the native library is not available")
    env = env or {}
    names = (ctypes.c_char_p * len(env))(*[k.encode() for k in env])
    values = (ctypes.c_double * len(env))(*[float(v) for v in env.values()])
    err = ctypes.c_int(0)
    out = lib.marlin_eval(
        expr.encode(),
        ctypes.cast(names, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(values, ctypes.POINTER(ctypes.c_double)),
        len(env),
        ctypes.byref(err),
    )
    if err.value:
        raise NativeError(lib.marlin_last_error().decode(errors="replace"))
    return float(out)
