"""Build-at-first-use loader for the hand-written Hopper kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (plain C interfaces, no PyTorch headers, so each
takes seconds), one process per source, all started together, and links the objects
into one shared library in ``m3t_tpu_torch/_build/``, keyed by a hash of all sources.
The library is loaded with ctypes.  Nothing here runs at import time: the CPU path
never needs ``nvcc`` or a card.
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


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.m3t_sample_lines.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.m3t_sample_lines.restype = i32
    lib.m3t_bin_counts.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.m3t_bin_counts.restype = i32
    lib.m3t_sample_windows.argtypes = ([ptr, ctypes.c_longlong, i32, i32] + [ptr] * 6
                                       + [i32] * 4 + [ptr])
    lib.m3t_sample_windows.restype = i32
    lib.m3t_query_eval.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.m3t_query_eval.restype = i32
    lib.m3t_scene_coeffs.argtypes = ([ptr] * 5 + [ctypes.c_longlong] * 5 + [ptr] * 9
                                     + [i32] * 3 + [ctypes.c_float, i32, ptr])
    lib.m3t_scene_coeffs.restype = i32
    lib.m3t_newton_step.argtypes = [ptr] * 4 + [i32, ctypes.c_float, ctypes.c_float, ptr]
    lib.m3t_newton_step.restype = i32
    return lib


def require(cond: bool, msg: str) -> None:
    """Argument check of the kernel wrappers: raises ValueError(msg) unless cond."""
    if not cond:
        raise ValueError(msg)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
