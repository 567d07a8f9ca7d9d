"""Build the package's CUDA sources with nvcc and load them with ctypes,
and check the tensors a launcher hands them.

Each `csrc/<name>.cu` becomes a shared library with a plain C interface,
built at first use into `rt_tpu_torch/_build/` (listed in .gitignore)
under a name keyed by a hash of the CUDA sources (`*.cu` and the shared
`*.cuh` headers) and its flags, so an edit rebuilds and an unchanged
tree reuses the library. No PyTorch header is compiled: a build takes
seconds, not minutes.

nvcc is found on PATH, else at $CUDA_HOME/bin/nvcc, else at the CUDA
toolkit's default /usr/local/cuda/bin/nvcc; without it, building raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# Flags of one library on top of NVCC_FLAGS. The megakernels (mega.cu,
# queue.cu) and their adjoints (mega_adjoint.cu, queue_adjoint.cu) are
# built without FMA contraction: then every multiply and add rounds as
# the plain versions' separate torch ops do, and kernel and plain version
# agree bit for bit per lane; with contraction an ulp now and then flips
# a grazing hit and sends a path elsewhere (ROADMAP C-6), and an
# adjoint's g * (L - C_after) / att picks up noise where L ~ C_after. The
# tape capture (capture.cu) shares their bounce, and its codes must be
# the plain version's on every lane and bounce. The regeneration kernel
# (regen.cu) shares it too, and its in-kernel camera rays
# (camera.cuh) must be ops/camera.generate_rays's bits.
LIB_FLAGS = {name: ("--fmad=false",)
             for name in ("mega", "queue", "mega_adjoint", "queue_adjoint",
                          "capture", "regen")}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)"
        "; the CUDA kernels of rt_tpu_torch need the CUDA toolkit")


def flags(name: str, defines: tuple = ()) -> tuple:
    """The nvcc flags of csrc/<name>.cu, with `-D` for each of `defines`
    (e.g. "RTT_DENSE_MAX=0": a scratch build of a compile-time constant,
    which the package itself never passes)."""
    return (NVCC_FLAGS + LIB_FLAGS.get(name, ())
            + tuple(f"-D{d}" for d in defines))


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where the library for csrc/<name>.cu lives, keyed by content and
    flags."""
    h = hashlib.sha256(" ".join(flags(name, defines)).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, defines: tuple = ()) -> Path:
    """Compile csrc/<name>.cu (with `defines`) unless the keyed library
    exists. The compiler's report (ptxas registers, shared memory,
    spills) is kept beside it as <library>.log."""
    path = library_path(name, defines)
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *flags(name, defines), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {res.returncode}):\n{res.stderr}")
    path.with_name(path.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    return path


def check_tensor(name, x, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on
    `device`: what a kernel takes by raw pointer."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, want {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, want {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, want {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per
    process and `defines`."""
    return ctypes.CDLL(str(build(name, defines)))
