"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Every ``csrc/*.cu`` compiles to an object, one nvcc process per source,
all started together, and the objects link into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o <name>.o csrc/<name>.cu          # each source, in parallel
    nvcc -shared -o build/torch_kernels/yam_kernels_<hash>.so *.o

The file name carries a hash of the sources and flags: the library is built
at first use and rebuilt only when a source changes.  nvcc is taken from
``PATH``, else from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).  A
failed build or load raises; nothing falls back.

Every C function returns a CUDA error code, 0 for success; a kernel's
takes device pointers and the CUDA stream as ``c_void_p`` and returns
``cudaGetLastError()`` after its launch.  :func:`launch` and :func:`call`
raise when the code is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # registers, shared memory and spills of each kernel, into the log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: argtypes of every exported C function
SIGNATURES: Dict[str, Tuple] = {
    "yam_sepconv_u8_max_channels": (_I, _I, ctypes.POINTER(_I)),
    "yam_sepconv_u8": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "yam_histogram256_resident_blocks": (ctypes.POINTER(_I),),
    "yam_histogram256_u8": (_P, _P, _P, _L, _I, _I, _P),
    "yam_lut_apply_u8": (_P, _P, _P, _L, _L, _I, _I, _P),
    "yam_empty": (_P,),
    "yam_chamfer_resident_blocks": (_I, ctypes.POINTER(_I)),
    "yam_chamfer_u8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "yam_cc_min_index": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "yam_flood_resident_blocks": (_I, ctypes.POINTER(_I)),
    "yam_flood": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "yam_tile_histogram_u8": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "yam_median": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "yam_vminmax_rate": (_P, _I, _I, _P),
    "yam_bilateral_u8": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "yam_clahe_blend_u8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "yam_stream_grid_histogram": (_P, _P, _P, _I, _L, _I, _I, _P),
    "yam_clahe_stream_blend": (_P, _P, _P, _P, *(_I,) * 12, _P),
    "yam_region_scan_resident_blocks": (ctypes.POINTER(_I),),
    "yam_region_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "yam_hull_areas": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "yam_annotate": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "yam_filter2d_u8": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "yam_glcm_counts": (_P, _P, _I, _I, _I, _I, _I, _P),
    "yam_lbp_codes": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "yam_hog_cells": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    "yam_contour_seed": (*(_P,) * 8, _I, _I, _I, _I, _P),
    "yam_contour_rank_blocks": (ctypes.POINTER(_I),),
    "yam_contour_rank": (*(_P,) * 24, _I, _I, _I, _I, _I, _I, _P),
    "yam_contour_write": (*(_P,) * 7, _I, _I, _I, _I, _P),
    "yam_fourier_shared_limit": (ctypes.POINTER(_I),),
    "yam_fourier_lines": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _P),
    "yam_polygon_errors": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "yam_gradient_u8": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "yam_canny_candidates_u8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "yam_adaptive_threshold_u8": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "yam_region_grow_u8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources (headers included) and
    flags lives."""

    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_sources() + list(CSRC.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"yam_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "are compiled from csrc/ at first use"
    )


def build() -> Tuple[Path, float]:
    """Compile ``csrc/*.cu`` unless the library for them exists.

    Returns the library path and the seconds spent building (0.0 when it
    was already built).  The compilers' output goes to ``<library>.log``.
    """

    path = library_path()
    if path.is_file():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # private names, then an atomic rename: a concurrent build never sees
    # a half-written library
    work = BUILD_DIR / f"{path.stem}.{os.getpid()}.objs"
    work.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for src in _sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, proc))
    log, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode})")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{s.stem}.o") for s in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode})")
    seconds = time.perf_counter() - start
    shutil.rmtree(work, ignore_errors=True)
    path.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "\n".join(log))
    os.replace(tmp, path)
    return path, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""

    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.yam_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.yam_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def on_card(name: str, tensor) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for
    a CPU tensor (it runs its plain version); raises for any other device."""

    if tensor.is_cuda:
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"{name} takes CPU or CUDA tensors, got {tensor.device}")


#: the frame element types the texture kernels (LBP, the dense filter, HOG)
#: are instantiated for, in the order of the ``kind`` code they take
FRAME_KINDS = ("uint8", "uint16", "float32")


def frame_kind(name: str, tensor) -> int:
    """The ``kind`` code of ``tensor``'s element type for a kernel
    instantiated for :data:`FRAME_KINDS`; raises for any other type."""

    kind = str(tensor.dtype).removeprefix("torch.")
    if kind not in FRAME_KINDS:
        raise ValueError(f"{name} takes {', '.join(FRAME_KINDS)} frames on the card, got {tensor.dtype}")
    return FRAME_KINDS.index(kind)


def call(name: str, device, *args) -> None:
    """Call C function ``name`` with ``device`` current; raise if it
    returns a CUDA error."""

    import torch

    lib = library()
    with torch.cuda.device(device):
        code = getattr(lib, name)(*args)
    if code != 0:
        message = lib.yam_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({message})")


def launch(name: str, device, *args) -> None:
    """Call kernel launcher ``name`` on ``device``'s current CUDA stream;
    raise if the launch was refused (``cudaGetLastError()`` not 0)."""

    import torch

    call(name, device, *args, torch.cuda.current_stream(device).cuda_stream)


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "call", "library", "library_path", "launch", "on_card"]
