"""Host library: the z-buffer rasterizer (``rasterizer.cpp``) and the contour tracer
(``contours.cpp``) of model generation, and the PNG scanline unfilter (``png.cpp``) of
the frame reader (``utils/png.py``), built by ``g++`` at first use.

The flags are the JAX package's (``m3t_tpu/native/__init__.py``) letter for letter:
``-O3 -march=native`` lets GCC contract the rasterizer's edge functions into fused
multiply-adds, so other flags could move a pixel and every model built from it.  The
library goes to ``m3t_tpu_torch/_build/``, keyed by a hash of the sources, the flags and
the compiler with its ``-march=native`` target, so a build made on one machine is never
loaded on another.  A failed build raises with the compiler's output; nothing here falls
back to numpy.  Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "rasterizer.cpp", _DIR / "contours.cpp", _DIR / "png.cpp")
BUILD_DIR = _DIR.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _compiler_identity() -> bytes:
    """g++'s version and the target options that -march=native resolves to here."""
    runs = [subprocess.run(["g++", *args], capture_output=True, text=True, check=True,
                           timeout=60)
            for args in (("--version",), ("-march=native", "-Q", "--help=target"))]
    return "".join(run.stdout for run in runs).encode()


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + _compiler_identity())
    for source in SOURCES:
        digest.update(source.name.encode() + b"\0" + source.read_bytes())
    return BUILD_DIR / f"libm3t_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library unless a build of these exact inputs exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
    run = subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                         capture_output=True, text=True, check=False, timeout=300)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {so.name}:\n{run.stdout}{run.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rasterize_soup.restype = None
    lib.rasterize_soup.argtypes = [ptr, ptr, ptr, i32, f32, f32, f32, f32, i32, i32, f32,
                                   ptr, ptr, ptr]
    lib.m3t_find_contours.restype = ctypes.c_longlong
    lib.m3t_find_contours.argtypes = [ptr, i32, i32, ptr, ctypes.c_longlong, ptr, i32,
                                      ptr]
    lib.m3t_png_unfilter.restype = ctypes.c_longlong
    lib.m3t_png_unfilter.argtypes = [ptr, i32, ctypes.c_longlong, i32, ptr]
    return lib
