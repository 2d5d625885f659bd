"""Build the package's C++ and CUDA sources into shared libraries and load them.

Two routes, one cache. Each `csrc/<name>.cu` has a plain C interface and is
compiled by `nvcc` alone (no PyTorch headers, so a build takes seconds) into
`build/kernels/<name>-<hash>.so` at the repository root, keyed by a hash of
the source and the flags, at first use. The library is loaded with ctypes;
the wrapper in `ops/` declares the argument types and launches on PyTorch's
current stream.

Flags: sm_90a only; -O3; --fmad=false and no fast math, because the kernels'
outputs are compared bit for bit with plain fp32 PyTorch.

Each `csrc/<name>.cpp` is host code (the image codecs; NMS, IoU, the COCO
matcher and the s2d pack) compiled by the host C++ compiler (`$CXX`, else
`c++` or `g++` on PATH) with `HOST_FLAGS`, into the same directory under
the same kind of key. `-ffp-contract=off` keeps every `a*b + c` two rounded
operations, as numpy computes them (an FMA would differ in the last bit).
It needs no CUDA, so the CPU tests build it too. A missing compiler, a failed build or a library that
will not load raises `BuildError` naming the compiler or the file; nothing
gives way to another decoder. `BuildError` is no `OSError`, so a caller that
treats an unreadable image as a damaged one does not take it for one.

A build writes a file private to its process and renames it into place, so
processes that build the same source at once all load a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}      # name -> nvcc/ptxas output of the last build


class BuildError(RuntimeError):
    """No compiler, a failed build, or a built library that does not load."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                            "the CUDA kernels are built on a machine with the "
                            "CUDA toolkit")


def cxx_path() -> str:
    """The host C++ compiler: $CXX if it is set, else c++ or g++ on PATH."""
    want = os.environ.get("CXX")
    for cand in ([want] if want else ["c++", "g++"]):
        found = shutil.which(cand)
        if found:
            return found
    raise BuildError(f"host C++ compiler {want or 'c++/g++'} not found on PATH; "
                            f"the image codecs (csrc/*.cpp) are built with it at first use")


def _source(name: str) -> Path:
    """`csrc/<name>.cpp` (host) if it exists, else `csrc/<name>.cu`."""
    cpp = SRC_DIR / f"{name}.cpp"
    return cpp if cpp.exists() else SRC_DIR / f"{name}.cu"


def _command(name: str, out: Path):
    src = _source(name)
    if src.suffix == ".cpp":
        return [cxx_path(), *HOST_FLAGS, "-o", str(out), str(src)]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = _source(name)
    flags = HOST_FLAGS if src.suffix == ".cpp" else NVCC_FLAGS
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that is not built yet, one compiler process
    per source, all started together. Returns seconds per name (0 if cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = _command(name, tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise BuildError(f"{proc.args[0]} failed for "
                               f"{_source(name).name}:\n{log}")
        os.replace(tmp, out)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cpp` or `.cu`; cached per
    process (loader threads may ask at once)."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise BuildError(f"{path} was built but does not load ({e}); delete it "
                                 f"to rebuild it with this machine's compiler") from e
            _LIBS[name] = lib
    return lib
