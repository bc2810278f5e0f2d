"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into ``build/kernels/<name>-<hash>.so``
beside the package, at first use.  The hash covers the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded.  Pointers and the stream cross the boundary as ``c_void_p``;
every launcher returns the launch's ``cudaError_t``.

Nothing here runs at import: the CPU has no ``nvcc``, and the tests
import every module.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures (argtypes, restype) of each library's functions.
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
SIGNATURES = {
    "fused_bottleneck": {
        "fused_bottleneck_launch":
            ([_INT] + [_PTR] * 10 + [_INT] * 8 + [_PTR], _INT),
        "fused_bottleneck_flat_launch":
            ([_INT] + [_PTR] * 11 + [_INT] * 7 + [_PTR], _INT),
        "fused_bottleneck_error_string": ([_INT], ctypes.c_char_p),
    },
    "fused_attention": {
        "fused_attention_launch":
            ([_INT] + [_PTR] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [_INT] * 4 + [ctypes.c_float, _PTR], _INT),
        "fused_attention_smem_bytes": ([_INT] * 3, ctypes.c_longlong),
        "fused_attention_error_string": ([_INT], ctypes.c_char_p),
    },
}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (
        CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not path or not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return path


def library_path(name):
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)):
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Returns {name: (seconds, nvcc's
    ptxas report)}; raises with nvcc's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target, time.perf_counter())
    # Wait for every nvcc before raising, so a failed build leaves no
    # compiler running behind it.
    done = {name: (proc.communicate()[0], proc.returncode, tmp, target,
                   time.perf_counter() - t0)
            for name, (proc, tmp, target, t0) in jobs.items()}
    report = {}
    for name, (output, returncode, tmp, target, seconds) in done.items():
        if returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{output}")
        os.replace(tmp, target)
        report[name] = (seconds, output)
    return report


@functools.lru_cache(maxsize=None)
def load(name):
    """The built library ``name`` with its launchers' signatures set."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
