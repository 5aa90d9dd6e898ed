"""Native (C++) extension loader with a lazy g++ build step.

The port's copy of the JAX package's loader, with its own sources and its
own build place: ``src/`` holds byte-for-byte copies of the JAX package's
``kafka_codec.cpp`` and ``seglog.cpp`` (raw CPython C API, built with a
direct g++ invocation), and each extension is built into the port's
gitignored build directory (``josefine_tpu_torch/build/``, beside the
kernel libraries) and registered as ``josefine_tpu_torch.native._<name>``.
It never loads the JAX package's ``.so`` files: both packages' extensions
export the same ``PyInit__<name>``, so a process that loads both gets one
module object from each file.

Nothing is built at import: :func:`load` builds a missing or stale
extension (older than its source) at first use.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

from josefine_tpu_torch.ops._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src")
_LOCK = threading.Lock()


def so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"_{name}{sysconfig.get_config_var('EXT_SUFFIX')}")


def ensure_built(name: str) -> str:
    """Compile ``src/<name>.cpp`` into ``build/_<name>.<ext>.so`` if missing
    or stale; returns the .so path."""
    cpp = os.path.join(SRC, f"{name}.cpp")
    so = so_path(name)
    with _LOCK:
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(cpp):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        include = sysconfig.get_paths()["include"]
        tmp = so + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            "-fvisibility=hidden", "-Wall",
            f"-I{include}", cpp, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"native build of {name} failed:\n{' '.join(cmd)}\n{e.stderr}"
            ) from None
        os.replace(tmp, so)  # atomic: concurrent builders race harmlessly
    return so


def load(name: str):
    """Import the built extension module ``_<name>`` (idempotent and
    thread-safe: exactly one module object per extension)."""
    so = ensure_built(name)
    modname = f"josefine_tpu_torch.native._{name}"
    with _LOCK:
        if modname in sys.modules:
            return sys.modules[modname]
        spec = importlib.util.spec_from_file_location(modname, so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[modname] = mod
        return mod
