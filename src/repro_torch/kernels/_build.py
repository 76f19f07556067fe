"""Build and load the port's CUDA kernels (nvcc -> one shared library,
bound with ctypes).

The sources under ``csrc/`` expose plain C entry points, so no PyTorch
header is compiled: each ``.cu`` is compiled by its own ``nvcc`` process
(all started together), the objects are linked into one ``.so`` under
``build/repro_torch_kernels/<content hash>/`` at the repository root,
and the library is loaded with ``ctypes``.  The build happens at first
use, never at import, and is skipped when a library for the same sources
and flags already exists.  A missing ``nvcc`` or a failed compile raises
with the compiler's output; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "decode_attention.cu", "ssd_scan.cu",
           "moe_gmm.cu")
HEADERS = ("common.cuh", "sm90.cuh")
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from repro_torch/kernels/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the shared library for the current sources lives."""
    return (_repo_root() / "build" / "repro_torch_kernels" / _digest()
            / LIB_NAME)


def build() -> Tuple[Path, float, str]:
    """Compile and link the kernels if needed.

    Returns ``(library path, build seconds, compiler output)`` — the
    output holds ``-Xptxas -v``'s registers / shared memory / spills per
    kernel; seconds and output are 0 and "" when the library existed."""
    out = library_path()
    if out.is_file():
        return out, 0.0, ""
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs: List[Tuple[str, subprocess.Popen]] = []
        objs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(lib_tmp),
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(lib_tmp, out)
    return out, time.perf_counter() - t0, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    return ctypes.CDLL(str(path))


@functools.cache
def entry(name: str, n_ptr: int, n_int: int, n_float: int = 0):
    """A C entry point with ``n_ptr`` pointer arguments, then ``n_int``
    ints, then ``n_float`` floats, then the stream pointer; returns the
    CUDA error code as an int."""
    fn = getattr(library(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def tma_readable(t) -> bool:
    """Whether TMA can load tensor ``t`` (the tensor-core variants' operand
    rule): innermost stride 1, every other stride a positive multiple of
    16 bytes, a 16-byte-aligned base address."""
    size = t.element_size()
    return (t.stride(-1) == 1
            and all(s > 0 and s * size % 16 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def rows16(t) -> bool:
    """Whether a kernel can read tensor ``t`` 16 bytes a thread along its
    last dim: that dim contiguous and a multiple of 16 bytes long, every
    other stride a multiple of 16 bytes (zero, a broadcast, included), a
    16-byte-aligned base."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.shape[-1] * size % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def c_int(value: int) -> int:
    """Validate an int passed as a C ``int`` (shapes, element strides)."""
    if not -2 ** 31 <= int(value) < 2 ** 31:
        raise ValueError(f"{value} does not fit a C int")
    return int(value)
