"""Build helper for the port's CUDA C++ kernels.

Each source under `sdrjfm_tpu_torch/csrc/` has a plain C interface and is
compiled by `nvcc` into its own shared library, which is loaded with
`ctypes`.  The library name carries a hash of the source and the flags, so a
changed source rebuilds and an unchanged one is loaded as it is.  The build
happens at first use, on the machine with the card, into `kernels/_build/`
(listed in `.gitignore`); nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ..runtime import spans

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper with its architecture-specific features.  No fast-math:
# the front end's NCO needs the accurate sincosf (the fast __sincosf is
# only good to ~2^-21.4 absolute near 0 and far worse for large arguments).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source additions: the RDS decoders and the fm chain's sub-block loops
# are feedback loops, so every multiply and add rounds on its own as in
# their plain versions (an FMA contraction moves the Costas phase and the
# bit clock from there on)
EXTRA_FLAGS = {"rds_scan.cu": ["-fmad=false"], "loops.cu": ["-fmad=false"]}
# the stamped build: the same source with clock64 stamps at the cluster
# kernels' stage boundaries (csrc/loops.cu SDR_STAMP), into a library of its
# own that only a measurement loads (chip_smoke.py phase stages); the
# kernel wrappers load the default build
STAMP_FLAGS = ["-DSDR_STAMP"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _flags(source: str, stamped: bool) -> list:
    return (NVCC_FLAGS + EXTRA_FLAGS.get(source, [])
            + (STAMP_FLAGS if stamped else []))


def library_path(source: str, stamped: bool = False) -> Path:
    """Where `source` (a file name under csrc/) builds to; `stamped`: its
    build with STAMP_FLAGS."""
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    h.update(" ".join(_flags(source, stamped)).encode())
    stem = Path(source).stem + ("_stamped" if stamped else "")
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(source: str, stamped: bool = False) -> Path:
    """Compile `source` unless its library is already built; returns the
    library path.  Raises with nvcc's output if the build fails."""
    out = library_path(source, stamped)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(source, stamped), "-o", str(tmp),
           str(CSRC / source)]
    spans.count("kernel.builds")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: str, stamped: bool = False) -> ctypes.CDLL:
    """The loaded library of `source` (its stamped build with `stamped`),
    built first if needed: the first load a span `setup.kernel_load`, an
    nvcc run a count in `kernel.builds` (`runtime.spans`)."""
    with _LOCK:
        key = (source, stamped)
        lib = _LIBS.get(key)
        if lib is None:
            with spans.span("setup.kernel_load"):
                lib = ctypes.CDLL(str(build(source, stamped)))
            _LIBS[key] = lib
        return lib


def ptxas_report(source: str, stamped: bool = False) -> str:
    """nvcc's -Xptxas -v output (registers, shared memory, spills) from the
    build of `source`, or '' if it was not built in this checkout."""
    p = BUILD_DIR / f"{library_path(source, stamped).stem}.ptxas.txt"
    return p.read_text() if p.exists() else ""
