"""Build the port's CUDA sources with nvcc at first use, load with ctypes.

Each `tcresnet_tpu_torch/csrc/<name>.cu` compiles on its own into a
shared library with a plain C entry point (no PyTorch headers, so a
build takes seconds). The library is named by a hash of its source, of
every shared header (`csrc/*.cuh`, which the sources include) and of the
compiler flags, so a stale build is never loaded, and is written
under a temporary name and renamed into place, so a build cut off
half-way is never loaded either. ptxas's register / shared-memory /
spill report is kept beside it as `<lib>.log`.

A missing nvcc or a failed build raises: there is no fallback.

Host code in C++ (`csrc/<name>.cc`, the wav decoder) is built the same
way by `build_host`, with g++ in the place of nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC_DIR / "build"

# sm_90a (not sm_90): Hopper's wgmma / setmaxnreg exist only for that
# target. No --use_fast_math: the front end's logf and sqrtf must stay
# IEEE-accurate for the 1e-5 softmax gate.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# the host libraries' flags (csrc/Makefile's, for the JAX package's copy)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")


def find_nvcc() -> str:
    """Path of nvcc: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked in PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu for the current sources lives.

    The digest covers the .cu and every csrc/*.cuh: a change to a shared
    header alone must not load a build of the old one."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless this exact source is already built."""
    return build_all([name])[name]


def build_all(names) -> Dict[str, Path]:
    """Compile every csrc/<name>.cu of `names` that is not built yet, one
    nvcc process per source, all started together; {name: library}."""
    libs = {name: library_path(name) for name in names}
    todo = {name: so for name, so in libs.items() if not so.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        for name, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{out}")
                continue
            todo[name].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def host_library_path(name: str) -> Path:
    """Where the build of the host source csrc/<name>.cc lives, named by a
    hash of the source and GXX_FLAGS."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cc").read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cc with g++ ($CXX when set) unless this exact
    source is already built; raises when the compiler is missing or fails."""
    so = host_library_path(name)
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (looked in $CXX and PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cc")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {name}.cc (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed. One
    load per process: a CDLL cannot be unloaded safely."""
    return ctypes.CDLL(str(build(name)))


def bind(name: str, args_type, entries, size_fn: str, error_fn: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu with its C entry points typed: each of
    `entries` takes (const Args*, stream) and returns a cudaError_t. The
    ctypes mirror `args_type` is checked against the C struct's size."""
    lib = load_library(name)
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    getattr(lib, error_fn).argtypes = [ctypes.c_int]
    getattr(lib, error_fn).restype = ctypes.c_char_p
    getattr(lib, size_fn).restype = ctypes.c_int
    c_size = getattr(lib, size_fn)()
    if c_size != ctypes.sizeof(args_type):
        raise RuntimeError(
            f"{args_type.__name__} layout mismatch: C {c_size} bytes, "
            f"ctypes {ctypes.sizeof(args_type)} bytes"
        )
    return lib


def launch(lib: ctypes.CDLL, entry: str, error_fn: str, args, device) -> None:
    """Call entry(&args, stream) on `device`'s current stream; raise if
    the launch was refused (cudaGetLastError() != 0)."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        msg = getattr(lib, error_fn)(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({rc})")
