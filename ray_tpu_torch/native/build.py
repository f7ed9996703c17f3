"""Build native components with the system compiler, cached by source
hash (no pip/pybind11: plain g++ -shared + ctypes)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))


def build_library(name: str, sources: list[str],
                  extra_flags: list[str] | None = None) -> str | None:
    """Compile `sources` (relative to native/) into lib<name>.so; returns
    the path, or None when no compiler is available."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    src_paths = [os.path.join(_DIR, s) for s in sources]
    tag = hashlib.sha256()
    for p in src_paths:
        with open(p, "rb") as f:
            tag.update(f.read())
    build_dir = os.path.join(_DIR, "build")
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"lib{name}-{tag.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    # per-pid tmp: concurrent cold-starting processes (raylet + workers)
    # each compile privately, then atomically publish — a shared tmp
    # path would interleave two g++ runs into one corrupt .so
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, "-O2", "-g", "-fPIC", "-shared", "-std=c++17",
           "-o", tmp, *src_paths, "-lpthread",
           *(extra_flags or [])]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.rename(tmp, out)
    return out
