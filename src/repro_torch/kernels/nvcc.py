"""Build CUDA sources into a shared library with a plain C interface.

Each kernel package compiles its ``csrc/`` sources at first use on the
card, one ``nvcc -c`` per source, all started together, and links them into
``build/<stem>-<hash>.so`` beside its wrapper (``build/`` is gitignored);
the hash covers the sources, headers and flags, so an edit rebuilds. The
library is loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps a build to seconds.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ at first use on the card")
    return found


def _run(procs) -> None:
    """Wait for every nvcc process; raise with the output of any that
    failed."""
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} -> {proc.returncode}\n{out}\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build_library(stem: str, sources: Sequence[Path],
                  headers: Sequence[Path], build_dir: Path,
                  flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``sources`` and link them into
    ``build_dir/<stem>-<hash>.so``, unless a library of the same sources,
    headers and flags is already there; returns its path."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in (*sources, *headers):
        h.update(src.read_bytes())
    out = build_dir / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    cc, tag = nvcc(), f"tmp{os.getpid()}"
    objs = [build_dir / f"{src.stem}-{tag}.o" for src in sources]
    _run([_start([cc, *flags, "-c", "-o", str(obj), str(src)])
          for src, obj in zip(sources, objs)])
    tmp = out.with_suffix(f".{tag}.so")
    _run([_start([cc, *flags, "-shared", "-o", str(tmp), *map(str, objs)])])
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out
