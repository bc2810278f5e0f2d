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
import re
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
            ([_INT] + [_PTR] * 10 + [_INT] * 9 + [_PTR], _INT),
        "fused_bottleneck_flat_launch":
            ([_INT] + [_PTR] * 11 + [_INT] * 8 + [_PTR], _INT),
        "fused_bottleneck_max_clusters": ([_INT] * 3, _INT),
        "fused_bottleneck_error_string": ([_INT], ctypes.c_char_p),
    },
    "fused_attention": {
        "fused_attention_launch":
            ([_INT] + [_PTR] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [_INT] * 4 + [ctypes.c_float, _PTR], _INT),
        "fused_attention_smem_bytes": ([_INT] * 3, ctypes.c_longlong),
        "fused_attention_error_string": ([_INT], ctypes.c_char_p),
    },
    "layer_norm": {
        "layer_norm_launch":
            ([_INT, _INT, _PTR, ctypes.c_longlong] + [_PTR] * 3
             + [ctypes.c_longlong, _INT, ctypes.c_float, _PTR], _INT),
        "layer_norm_error_string": ([_INT], ctypes.c_char_p),
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


def library_path(name, source=None):
    """Where the library of ``name`` built from ``source`` (default
    ``csrc/<name>.cu``) lives."""
    source = Path(source) if source else CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES), variants=()):
    """Compile every named source, and every variant ``(label, name,
    source)`` (another source with the C interface of ``name``), that is
    not built yet, one ``nvcc`` per library, all started together.
    Returns {name or label: (seconds, nvcc's ptxas report)}; raises with
    nvcc's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, name, source in (
            [(name, name, None) for name in names] + list(variants)):
        target = library_path(name, source)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(source or CSRC / f"{name}.cu")]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    # Wait for every nvcc before raising, so a failed build leaves no
    # compiler running behind it.
    done = {label: (proc.communicate()[0], proc.returncode, tmp, target,
                    time.perf_counter() - t0)
            for label, (proc, tmp, target, t0) in jobs.items()}
    report = {}
    for label, (output, returncode, tmp, target, seconds) in done.items():
        if returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{output}")
        target.with_suffix(".ptxas").write_text(output)
        os.replace(tmp, target)
        report[label] = (seconds, output)
    return report


def ptxas_output(name, source=None):
    """nvcc's output from the build of that library (as for
    ``library_path``), kept beside it; "" if it was not built here."""
    log = library_path(name, source).with_suffix(".ptxas")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name, source=None):
    """The built library ``name`` (from ``source``, as for
    ``library_path``) with its launchers' signatures set."""
    build((), [(name, name, source)])
    lib = ctypes.CDLL(str(library_path(name, source)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _names(mangled, pos):
    """The ``<length><name>`` pieces of a mangled name from ``pos``: (the
    last name, the position after them)."""
    name = None
    while (m := re.match(r"\d+", mangled[pos:])):
        size = int(m.group())
        name = mangled[pos + m.end():pos + m.end() + size]
        pos += m.end() + size
    return name, pos


def _short_name(mangled):
    """``_ZN<namespace>20attention_mma_kernelILi4ELi13EEEv...`` ->
    ``attention_mma_kernel<4,13>``: the kernel's name and the integer,
    bool and class arguments of its template (a class by its last name:
    ``NS_12ScalarEngineE`` -> ``ScalarEngine``), so the build's ptxas
    report names each template instance legibly."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    name, pos = _names(mangled, m.end())
    if name is None:
        return mangled
    if not mangled.startswith("I", pos):
        return name
    pos, args = pos + 1, []
    while pos < len(mangled) and mangled[pos] != "E":
        if (m := re.match(r"L[a-z](\d+)E", mangled[pos:])):  # int, bool
            args.append(m.group(1))
            pos += m.end()
        elif mangled[pos] == "N":  # a nested name, maybe after a
            m = re.match(r"N(S\d*_)?", mangled[pos:])  # substitution
            arg, pos = _names(mangled, pos + m.end())
            if arg is None or not mangled.startswith("E", pos):
                break
            args.append(arg)
            pos += 1
        else:
            arg, pos = _names(mangled, pos)
            if arg is None:
                break
            args.append(arg)
    return f"{name}<{','.join(args)}>"


def ptxas_report(output):
    """[(kernel, registers, spill store bytes, spill load bytes)] of every
    kernel instance in nvcc's ``-Xptxas -v`` output."""
    rows, current, spills = [], None, (0, 0)
    for line in output.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            rows.append((_short_name(current), int(m.group(1)), *spills))
            current, spills = None, (0, 0)
    return rows
