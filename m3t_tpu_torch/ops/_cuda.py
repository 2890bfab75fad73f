"""Build-at-first-use loader for the hand-written Hopper kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (plain C interfaces, no PyTorch headers, so each
takes seconds), one process per source, all started together, and links the objects
into one shared library in ``m3t_tpu_torch/_build/``, keyed by a hash of all sources.
The library is loaded with ctypes.  Nothing here runs at import time: the CPU path
never needs ``nvcc`` or a card.

Every kernel is declared once, by :func:`kernel` on its wrapper: the C entry point's
symbol and its argument types, the stream (the last argument of every entry point)
left out.  :func:`launch` calls a declared entry point on the current stream of a
device and counts the launch on the wrapper (``sample_lines.launches``, ...), whatever
name the wrapper's module holds at the time; :func:`wrappers` lists the declared
wrappers, whose counts graphs.py takes into and out of its captures.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
BUILD_DIR = _PACKAGE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for source in SOURCES:
        digest.update(source.name.encode() + b"\0" + source.read_bytes())
    return BUILD_DIR / f"libm3t_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists; returns the .so.

    The compiler's resource reports (``-Xptxas -v``) go to ``<so>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{source.stem}.o" for source in SOURCES]
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for source, obj in zip(SOURCES, objects)]
    logs = [f"== {source.name}\n{proc.communicate()[0]}"
            for source, proc in zip(SOURCES, procs)]
    failed = [source.name for source, proc in zip(SOURCES, procs) if proc.returncode != 0]
    tmp = so.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objects)],
                              capture_output=True, text=True, check=False)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objects:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(logs))
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


# Argument types of the entry points: device pointers, int, long long and float.
PTR, INT, INT64, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_WRAPPERS: dict = {}  # C symbol -> its wrapper, in declaration order


def kernel(symbol: str, argtypes):
    """Declare the wrapper's kernel: its C entry point ``symbol`` in ``csrc/*.cu``, which
    returns a cudaError_t as int, and its argument types before the stream.  Returns the
    wrapper itself, its launch count at 0."""
    def declare(wrapper):
        wrapper.symbol, wrapper.argtypes, wrapper.launches = symbol, tuple(argtypes), 0
        _WRAPPERS[symbol] = wrapper
        return wrapper
    return declare


def wrappers() -> tuple:
    """The declared kernel wrappers (of the modules imported so far)."""
    return tuple(_WRAPPERS.values())


@functools.cache
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


@functools.cache
def _entry(symbol: str):
    """The library's entry point ``symbol`` with its declared argument types."""
    entry = getattr(library(), symbol)
    entry.argtypes = [*_WRAPPERS[symbol].argtypes, PTR]
    entry.restype = INT
    return entry


def launch(symbol: str, device: torch.device, *args) -> None:
    """Call the declared entry point ``symbol`` with args and the current stream of
    device, raise on a launch error, and count the launch on its wrapper."""
    with torch.cuda.device(device):
        err = _entry(symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: cudaError {err}")
    _WRAPPERS[symbol].launches += 1


def require(cond: bool, msg: str) -> None:
    """Argument check of the kernel wrappers: raises ValueError(msg) unless cond."""
    if not cond:
        raise ValueError(msg)
