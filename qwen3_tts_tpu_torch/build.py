"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.
The library is built at first use into ``qwen3_tts_tpu_torch/_build/``
(listed in ``.gitignore``) and rebuilt whenever a source changes: its file
name carries a hash of the sources. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqwen3_tts_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the current sources are already built.

    Returns the library path. A build prints ``nvcc``'s register and
    shared-memory report (``-Xptxas -v``) and each source's compile time
    to stderr; a cached library prints nothing.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    logs = [obj.with_suffix(".log") for obj in objects]
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(sources, objects, logs):
        with open(log, "w") as err:
            procs.append(subprocess.Popen(
                [nvcc, "-Xptxas", "-v", *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.DEVNULL, stderr=err,
            ))
    try:
        # Each source's compile time, for the build's report.
        seconds = [None] * len(procs)
        while None in seconds:
            time.sleep(0.05)
            for i, proc in enumerate(procs):
                if seconds[i] is None and proc.poll() is not None:
                    seconds[i] = time.perf_counter() - t0
        errs = [log.read_text() for log in logs]
        failed = [
            f"{src.name} ({proc.returncode}):\n{err}"
            for src, proc, err in zip(sources, procs, errs)
            if proc.returncode != 0
        ]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *[str(o) for o in objects]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        print("".join(errs), file=sys.stderr)
        print("nvcc seconds: " + ", ".join(f"{src.name} {t:.1f}" for src, t in zip(sources, seconds)), file=sys.stderr)
        os.replace(tmp, out)
    finally:
        for path in objects + logs:
            path.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed (once per process)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
