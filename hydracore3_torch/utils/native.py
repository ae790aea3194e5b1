"""Build native shared libraries from the repo's sources at first use.

Each library is compiled into ``hydracore3_torch/_build/`` under a file name
that carries a hash of its sources and compiler command, so a changed
source is rebuilt and an unchanged one is loaded as it is.  The compiler
writes to a temporary name that is renamed into place, so concurrent
processes never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, '_build')


def build_shared_library(name: str, sources: list[str], cmd: list[str]
                         ) -> tuple[str, float]:
    """Compile ``sources`` with ``cmd + ['-o', <out>] + sources`` unless a
    library built from the same inputs exists.

    Returns (path to the library, seconds spent compiling; 0 when it was
    already built)."""
    h = hashlib.sha256(' '.join(cmd).encode())
    for src in sources:
        with open(src, 'rb') as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f'{name}-{h.hexdigest()[:16]}.so')
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + ['-o', tmp] + sources, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f'building {name} failed:\n{proc.stderr}')
    os.replace(tmp, out)
    return out, time.perf_counter() - t0
