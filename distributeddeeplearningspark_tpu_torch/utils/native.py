"""ctypes loader for the port's host (C++) data-plane kernels.

``csrc/dls_native.cc`` (crop/flip/normalize, bilinear resize, the fused
random-resized-crop and its variable-size batch form, ``sum_into``) and
``csrc/dls_jpeg.cc`` (a baseline JPEG decoder) are the port's copies of the
JAX package's sources of the same names, bound here as the JAX package's
``utils/native.py`` binds its own: one shared library, a plain C interface,
``ctypes`` (which releases the GIL around every call, so these kernels run
in parallel with the prefetch thread). They run on the host, not on the
card.

Building: at first use, ``g++`` (``$CXX`` when set) compiles both sources
into ``build/native/_dls_native-<hash>.so`` under the checkout's root, the
hash covering the sources and the flags. Each process that builds links
into a file of its own (``mkstemp``) and renames it into place, so the test
workers and the input pipeline's worker processes may build at once. The library is loaded
with ctypes' default ``RTLD_LOCAL``: its ``dls_*`` symbols do not collide
with the JAX package's library of the same symbols in one process.

A failed build or load raises, with the compiler's output: no path falls
back to numpy on its own. The numpy chain is each kernel's plain version,
taken only where the caller asks for it by setting ``DLS_DISABLE_NATIVE``
(read at each call), as the JAX package's own switch does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("dls_native.cc", "dls_jpeg.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
#: the environment switch that selects the numpy plain versions
DISABLE_ENV = "DLS_DISABLE_NATIVE"

#: dls_jpeg.cc return codes
_JPEG_OK = 0
_JPEG_UNSUPPORTED = -2

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode() + (CSRC_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"_dls_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library is built already; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=path.parent)
    os.close(fd)
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") from e
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed (rc {out.returncode}): "
                           f"{' '.join(cmd)}\n{out.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dls_version.restype = ctypes.c_int
    lib.dls_num_threads.restype = ctypes.c_int
    lib.dls_crop_flip_normalize_batch.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i32p, _i32p, _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
    ]
    lib.dls_normalize_u8_batch.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, _f32p,
    ]
    lib.dls_resize_bilinear.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _f32p,
    ]
    lib.dls_rrc_flip_normalize.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
    ]
    lib.dls_rrc_flip_normalize_varbatch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), _i32p, _i32p, ctypes.c_int,
        _i32p, _i32p, _i32p, _i32p, _u8p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
    ]
    lib.dls_sum_into_f32.argtypes = [_f32p, _f32p, ctypes.c_int64]
    lib.dls_jpeg_info.restype = ctypes.c_int
    lib.dls_jpeg_info.argtypes = [
        _u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dls_jpeg_decode.restype = ctypes.c_int
    lib.dls_jpeg_decode.argtypes = [_u8p, ctypes.c_int64, _u8p, ctypes.c_int64]
    lib.dls_jpeg_decode_batch.restype = None
    lib.dls_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def _load() -> ctypes.CDLL | None:
    """The loaded library, built first when needed; None only when
    ``DLS_DISABLE_NATIVE`` asks for the plain versions. Raises when the
    build or the load fails."""
    global _lib
    if os.environ.get(DISABLE_ENV):
        return None
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def available() -> bool:
    """True unless ``DLS_DISABLE_NATIVE`` selects the plain versions (a
    library that cannot be built raises here)."""
    return _load() is not None


def num_threads() -> int:
    """The threads a kernel call fans out to (``DLS_NATIVE_THREADS`` caps it)."""
    lib = _load()
    return lib.dls_num_threads() if lib is not None else 1


# ---------------------------------------------------------------------------
# Kernels, each with its numpy plain version (the same semantics)
# ---------------------------------------------------------------------------

def crop_flip_normalize_batch(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                              flips: np.ndarray, crop: tuple[int, int],
                              mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """[N, H, W, C] uint8, crop origins ``ys``/``xs``, horizontal ``flips``
    → [N, ch, cw, C] f32 ``(x/255 - mean)/std``."""
    n, h, w, c = images.shape
    ch, cw = crop
    images = np.ascontiguousarray(images, np.uint8)
    ys = np.ascontiguousarray(ys, np.int32)
    xs = np.ascontiguousarray(xs, np.int32)
    # the kernel reads raw offsets: an invalid origin would be a heap read
    # out of bounds there, where numpy would give a short slice
    if len(ys) != n or len(xs) != n:
        raise ValueError(f"ys/xs must have length {n}: got {len(ys)}/{len(xs)}")
    if ch > h or cw > w:
        raise ValueError(f"crop {crop} exceeds image size {(h, w)}")
    bad = (ys < 0) | (ys > h - ch) | (xs < 0) | (xs > w - cw)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"crop origin out of bounds at index {i}: y={ys[i]} x={xs[i]} "
            f"for image {(h, w)} crop {crop}")
    flips = np.ascontiguousarray(flips, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((n, ch, cw, c), np.float32)
    lib = _load()
    if lib is not None:
        lib.dls_crop_flip_normalize_batch(
            images, n, h, w, c, ys, xs, flips, ch, cw, mean, std, out)
        return out
    for i in range(n):
        img = images[i, ys[i]:ys[i] + ch, xs[i]:xs[i] + cw]
        if flips[i]:
            img = img[:, ::-1]
        out[i] = (img.astype(np.float32) / 255.0 - mean) / std
    return out


def normalize_u8_batch(images: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """[N, H, W, C] uint8 → standardized f32 (no crop or flip)."""
    n, h, w, c = images.shape
    images = np.ascontiguousarray(images, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty((n, h, w, c), np.float32)
        lib.dls_normalize_u8_batch(images, n, h, w, c, mean, std, out)
        return out
    return (images.astype(np.float32) / 255.0 - mean) / std


def _check_region(region, h: int, w: int, what: str = "") -> None:
    y0, x0, ch, cw = region
    if not (0 <= y0 and 0 <= x0 and ch > 0 and cw > 0
            and y0 + ch <= h and x0 + cw <= w):
        raise ValueError(f"{what}crop region {tuple(region)} out of bounds "
                         f"for {(h, w)}")


def rrc_flip_normalize(image: np.ndarray, region: tuple[int, int, int, int],
                       flip: bool, size: tuple[int, int], mean: np.ndarray,
                       std: np.ndarray) -> np.ndarray | None:
    """Fused crop (``region`` = y0, x0, ch, cw) → bilinear resize to
    ``size`` → flip → ``(x/255 - mean)/std`` of an [H, W, C] uint8 image in
    one pass with no float frame. None under ``DLS_DISABLE_NATIVE``: the
    caller takes the numpy chain (``vision.train_transform`` does)."""
    lib = _load()
    if lib is None:
        return None
    h, w, c = image.shape
    _check_region(region, h, w)
    y0, x0, ch, cw = region
    image = np.ascontiguousarray(image, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    oh, ow = size
    out = np.empty((oh, ow, c), np.float32)
    lib.dls_rrc_flip_normalize(image, h, w, c, y0, x0, ch, cw, int(flip),
                               oh, ow, mean, std, out)
    return out


def rrc_flip_normalize_varbatch(images: list[np.ndarray], regions: np.ndarray,
                                flips: np.ndarray, size: tuple[int, int],
                                mean: np.ndarray, std: np.ndarray,
                                out: np.ndarray | None = None) -> np.ndarray | None:
    """:func:`rrc_flip_normalize` over N images of differing sizes in one
    call (parallel over images), written into ``out`` ([N, OH, OW, C] f32,
    made when None). None under ``DLS_DISABLE_NATIVE``: the caller takes the
    per-example chain."""
    lib = _load()
    if lib is None:
        return None
    n = len(images)
    c = images[0].shape[2]
    oh, ow = size
    regions = np.ascontiguousarray(regions, np.int32)
    if regions.shape != (n, 4):
        raise ValueError(f"regions must be [{n}, 4], got {regions.shape}")
    hs = np.empty(n, np.int32)
    ws = np.empty(n, np.int32)
    ptrs = (ctypes.c_void_p * n)()
    contig = []  # alive for the duration of the call
    for i, img in enumerate(images):
        img = np.ascontiguousarray(img, np.uint8)
        if img.ndim != 3 or img.shape[2] != c:
            raise ValueError(f"image {i}: want [H, W, {c}] u8, got {img.shape}")
        h, w = img.shape[:2]
        _check_region(regions[i], h, w, f"image {i}: ")
        hs[i], ws[i] = h, w
        contig.append(img)
        ptrs[i] = img.ctypes.data_as(ctypes.c_void_p)
    # a short flips/mean/std would be a heap read out of bounds in the kernel
    flips = np.ascontiguousarray(flips, np.uint8)
    if len(flips) != n:
        raise ValueError(f"flips must have length {n}, got {len(flips)}")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if len(mean) != c or len(std) != c:
        raise ValueError(f"mean/std must have length {c}, got {len(mean)}/{len(std)}")
    if out is None:
        out = np.empty((n, oh, ow, c), np.float32)
    elif out.shape != (n, oh, ow, c) or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous [{n}, {oh}, {ow}, {c}] f32")
    lib.dls_rrc_flip_normalize_varbatch(
        ptrs, hs, ws, c,
        np.ascontiguousarray(regions[:, 0]), np.ascontiguousarray(regions[:, 1]),
        np.ascontiguousarray(regions[:, 2]), np.ascontiguousarray(regions[:, 3]),
        flips, n, oh, ow, mean, std, out)
    del contig
    return out


def resize_bilinear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """[H, W, C] (or [H, W]) f32 → resized, half-pixel centres, edge-clamped
    (``vision.resize_bilinear``'s arithmetic)."""
    if image.ndim == 2:
        return resize_bilinear(image[..., None], size)[..., 0]
    h, w, c = image.shape
    oh, ow = size
    if (h, w) == (oh, ow):
        return np.asarray(image, np.float32)
    image = np.ascontiguousarray(image, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty((oh, ow, c), np.float32)
        lib.dls_resize_bilinear(image, h, w, c, oh, ow, out)
        return out
    from distributeddeeplearningspark_tpu_torch.data import vision

    return vision.resize_bilinear(image, size)


class JpegUnsupported(ValueError):
    """A valid JPEG in a coding mode outside baseline (progressive, 12-bit,
    arithmetic, CMYK): callers hand it to PIL."""


def _jpeg_shape(lib, buf: np.ndarray, what: str) -> tuple[int, int, int]:
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.dls_jpeg_info(buf, buf.size, ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c))
    if rc == _JPEG_UNSUPPORTED:
        raise JpegUnsupported(f"non-baseline JPEG{what} (progressive/12-bit/arith)")
    if rc != _JPEG_OK:
        raise ValueError(f"malformed JPEG{what} (dls_jpeg_info rc={rc})")
    return h.value, w.value, c.value


def jpeg_decode(data: bytes) -> np.ndarray | None:
    """Baseline JPEG bytes → uint8 HWC. None under ``DLS_DISABLE_NATIVE``;
    raises :class:`JpegUnsupported` for non-baseline streams and
    ``ValueError`` for malformed data."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(_jpeg_shape(lib, buf, ""), np.uint8)
    rc = lib.dls_jpeg_decode(buf, buf.size, out.reshape(-1), out.size)
    if rc == _JPEG_UNSUPPORTED:
        raise JpegUnsupported("non-baseline JPEG (progressive/12-bit/arith)")
    if rc != _JPEG_OK:
        raise ValueError(f"malformed JPEG (dls_jpeg_decode rc={rc})")
    return out


def jpeg_decode_batch(datas: list[bytes]) -> list[np.ndarray] | None:
    """Decode many baseline JPEGs in parallel (a C++ thread an image). None
    under ``DLS_DISABLE_NATIVE``; any image that fails raises."""
    lib = _load()
    if lib is None:
        return None
    n = len(datas)
    if n == 0:
        return []
    bufs = [np.frombuffer(d, np.uint8) for d in datas]
    outs = [np.empty(_jpeg_shape(lib, b, " in batch"), np.uint8) for b in bufs]
    data_ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    lens = (ctypes.c_int64 * n)(*[b.size for b in bufs])
    out_ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    out_lens = (ctypes.c_int64 * n)(*[o.size for o in outs])
    rcs = (ctypes.c_int * n)()
    lib.dls_jpeg_decode_batch(data_ptrs, lens, out_ptrs, out_lens, n, rcs)
    for i in range(n):
        if rcs[i] == _JPEG_UNSUPPORTED:
            raise JpegUnsupported(f"non-baseline JPEG at batch index {i}")
        if rcs[i] != _JPEG_OK:
            raise ValueError(f"malformed JPEG at batch index {i} (rc={rcs[i]})")
    return outs


def sum_into(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``dst += src`` (f32, flattened) in place; returns ``dst``."""
    if dst.dtype != np.float32 or not dst.flags.c_contiguous:
        # reshape(-1) of a non-contiguous dst would copy, and the kernel
        # would add into the copy
        raise ValueError("sum_into needs a C-contiguous float32 dst")
    if src.size != dst.size:
        # the kernel reads dst.size floats from src
        raise ValueError(f"sum_into size mismatch: dst {dst.size} vs src {src.size}")
    src = np.ascontiguousarray(src, np.float32)
    lib = _load()
    if lib is not None:
        lib.dls_sum_into_f32(dst.reshape(-1), src.reshape(-1), dst.size)
        return dst
    dst += src
    return dst
