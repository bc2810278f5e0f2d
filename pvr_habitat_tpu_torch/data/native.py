"""ctypes bindings for the native image codec (counterpart of
``pvr_habitat_tpu/data/native.py``; source ``native/image_codec.cpp``).

The library is built on first use with ``g++`` against libpng and
libjpeg into ``build/codec/libpvr_codec-<hash>.so`` beside the package
(the hash covers the source and the flags); nothing is written under
``native/``.  Where the toolchain or the libraries are missing, decoding
falls back to cv2, then PIL, as in the JAX package; with neither it
raises and names what is missing.  ``codec()`` names the decoder that
runs.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "image_codec.cpp"
BUILD_DIR = ROOT / "build" / "codec"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lib = None
_tried = False
_why = ""
_lock = threading.Lock()


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libpvr_codec-{digest.hexdigest()[:16]}.so"


def _build(target):
    """g++ into a file of this process, then renamed into place, so that
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE), *LIBS],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried, _why
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except FileNotFoundError as exc:          # no g++
            _why = f"no compiler: {exc}"
            return None
        except subprocess.CalledProcessError as exc:
            _why = f"g++ failed: {exc.stderr.strip()[-300:]}"
            return None
        except OSError as exc:
            _why = f"cannot load the library: {exc}"
            return None
        lib.decode_image_batch.restype = ctypes.c_int
        lib.decode_image_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.count_frames.restype = ctypes.c_int
        lib.count_frames.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib


def available():
    return _load() is not None


def _module(name):
    try:
        return __import__(name)
    except ImportError:
        return None


def codec():
    """The decoder ``decode_batch`` uses: native, cv2 or PIL (None when
    there is none)."""
    if available():
        return "native"
    for name in ("cv2", "PIL"):
        if _module(name) is not None:
            return name
    return None


def decode_batch(paths, h=64, w=64, kind="png", bgr=True, n_threads=None):
    """Decode a list of image files -> (N, h, w, 3) uint8.

    bgr=True matches cv2.imread channel order (the PNG layout's files
    are written via cv2.imwrite, reference save_opt_trajectories_png).
    Raises ValueError naming the failing file.
    """
    lib = _load()
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    if lib is None:
        return _decode_fallback(paths, out, kind, bgr)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    n_threads = n_threads or min(os.cpu_count() or 1, 16)
    rc = lib.decode_image_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, 0 if kind == "png" else 1, 1 if bgr else 0, n_threads)
    if rc != 0:
        raise ValueError(f"failed to decode {paths[rc - 1]}")
    return out


def _decode_fallback(paths, out, kind, bgr):
    cv2 = _module("cv2")
    if cv2 is not None:
        for i, path in enumerate(paths):
            img = cv2.imread(path)
            if img is None:
                raise ValueError(f"failed to decode {path}")
            out[i] = img if bgr else img[..., ::-1]
        return out
    if _module("PIL") is not None:
        from PIL import Image

        for i, path in enumerate(paths):
            img = np.asarray(Image.open(path).convert("RGB"))
            out[i] = img[..., ::-1] if bgr else img
        return out
    raise RuntimeError(
        f"decoding {kind} needs the native codec (g++, libpng and libjpeg; "
        f"{_why}), cv2 or PIL, and none of them is here")


def count_frames(dir_path, stem, ext="png", max_steps=500):
    lib = _load()
    if lib is None:
        i = 0
        while i < max_steps and os.path.isfile(
                os.path.join(dir_path, f"{stem}_{i}.{ext}")):
            i += 1
        return i
    return lib.count_frames(dir_path.encode(), str(stem).encode(),
                            ext.encode(), max_steps)
