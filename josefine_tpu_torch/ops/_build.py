"""Build the port's C/CUDA sources at first use, and load them with ctypes.

Two libraries, each with a plain C interface:

* ``libfused_step.so`` — the Hopper kernel, ``nvcc`` for ``sm_90a``
  (``csrc/fused_step.cu``). Built on the machine with the card, never here.
  ``ptxas -v``'s report of each kernel (registers, spills, shared memory)
  is kept beside it, in ``libfused_step.so.ptxas.txt``.
* ``libfused_step_host.so`` — the same tick body compiled by ``g++`` for
  the host emulation the CPU tests run (``csrc/fused_step_host.cpp``).

Nothing is built at import. A library is built into ``build/`` beside the
package's sources (gitignored) when it is missing or older than any source
under ``csrc/``, then loaded once per process. Concurrent builders race
harmlessly: each writes a private temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

_OPS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS), "build")
_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")


def _sources_mtime() -> float:
    return max(os.path.getmtime(os.path.join(CSRC, f)) for f in os.listdir(CSRC))


def _build(lib: str, cmd: list[str], report: bool = False) -> str:
    """Run ``cmd + [-o tmp]`` unless ``build/lib`` is newer than every
    source; returns the library's path. With ``report``, the compiler's
    stderr is kept in ``build/lib.ptxas.txt``."""
    path = os.path.join(BUILD_DIR, lib)
    if os.path.exists(path) and os.path.getmtime(path) >= _sources_mtime():
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    full = cmd + ["-o", tmp]
    res = subprocess.run(full, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"build of {lib} failed:\n{' '.join(full)}\n{res.stderr}")
    if report:
        with open(f"{tmp}.txt", "w") as f:
            f.write(res.stderr)
        os.replace(f"{tmp}.txt", f"{path}.ptxas.txt")
    os.replace(tmp, path)
    return path


def build_cuda() -> str:
    """Compile the Hopper kernel; returns the .so path."""
    return _build("libfused_step.so", [_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, "fused_step.cu")],
                  report=True)


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_NUM = {
    "registers": re.compile(r"Used (\d+) registers"),
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
    "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
    "static_smem_bytes": re.compile(r"(\d+) bytes smem"),
}


def ptxas_report(n: int) -> dict[str, int]:
    """``ptxas -v``'s figures for ``fused_window_kernel<n>`` in the built
    library: registers/thread, stack, spill stores and loads, static shared
    memory (the mailbox is dynamic shared memory, sized at launch)."""
    with open(os.path.join(BUILD_DIR, "libfused_step.so.ptxas.txt")) as f:
        text = f.read()
    sym = f"fused_window_kernelILi{n}EE"
    chunks = _PTXAS_ENTRY.split(text)
    for name, body in zip(chunks[1::2], chunks[2::2]):
        if sym in name:
            return {k: int(m.group(1)) if (m := rx.search(body)) else 0
                    for k, rx in _PTXAS_NUM.items()}
    raise KeyError(f"no ptxas report for fused_window_kernel<{n}>")


def build_host() -> str:
    """Compile the g++ host emulation of the tick body; returns the .so path."""
    return _build("libfused_step_host.so",
                  ["g++", *GXX_FLAGS, os.path.join(CSRC, "fused_step_host.cpp")])


_WINDOW_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _load(key: str, build, declare) -> ctypes.CDLL:
    """Build (if stale) and load a library once per process, declaring its
    functions' argument and return types."""
    with _LOCK:
        if key not in _LOADED:
            lib = ctypes.CDLL(build())
            declare(lib)
            _LOADED[key] = lib
        return _LOADED[key]


def _declare_cuda(lib) -> None:
    lib.josefine_fused_window.argtypes = _WINDOW_ARGS + [ctypes.c_void_p]
    lib.josefine_fused_window.restype = ctypes.c_int
    lib.josefine_fused_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.josefine_fused_kernel_info.restype = ctypes.c_int
    lib.josefine_cuda_error_string.argtypes = [ctypes.c_int]
    lib.josefine_cuda_error_string.restype = ctypes.c_char_p


def _declare_host(lib) -> None:
    lib.josefine_fused_window_host.argtypes = _WINDOW_ARGS
    lib.josefine_fused_window_host.restype = ctypes.c_int


def load_cuda() -> ctypes.CDLL:
    return _load("cuda", build_cuda, _declare_cuda)


def load_host() -> ctypes.CDLL:
    return _load("host", build_host, _declare_host)
