"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``pytorch_toolbelt_tpu_torch/csrc/`` is compiled
by ``nvcc`` for Hopper (``sm_90a``), one compiler process per file, all
started together, and the objects are linked into one shared library with a
plain C interface, which is loaded with :mod:`ctypes`.  The library's file name
carries a hash of the sources and the flags, so an unchanged tree reuses an
earlier build.  The build directory (``pytorch_toolbelt_tpu_torch/_build``)
is listed in ``.gitignore``.

Nothing here runs when the package is imported: the first launch of a kernel
on a CUDA tensor builds and loads the library.  Each C entry point returns
the ``cudaError_t`` of its launch; :func:`check` raises on anything but 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "check", "library", "stream_of"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name: (return type, argument types).  Sizes that can pass 2^31 are c_longlong.
_SIGNATURES = {
    # device, tiles, tiles_dtype, weight, out, out_dtype, norm_out, channels, th, tw,
    # ty, tx, sh, sw, out_h, out_w, off_y, off_x, normalize, eps, int* route taken (out), stream
    "ptt_grid_merge": (_I, [_I, _P, _I, _P, _P, _I, _P] + [_I] * 12 + [_F, _P, _P]),
    # device, canvas, norm, tiles, tiles_dtype, weight, coords, n_tiles, channels, height, width,
    # th, tw, box_y0, box_x0, box_h, box_w, stream
    "ptt_scatter_merge": (_I, [_I, _P, _P, _P, _I, _P, _P, _I, _I, _LL, _LL, _I, _I] + [_LL] * 4 + [_P]),
    # device, x, w, scale, bias, y, B, H, W, cin, cout, cin_pad, cout_pad, relu, stream
    "ptt_conv3x3_wmma_bf16": (_I, [_I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P]),
    # device, x, w, scale, bias, y, B, H, W, cin, cout, n_tile, relu, stream
    "ptt_conv3x3_wgmma_bf16": (_I, [_I, _P, _P, _P, _P, _P] + [_I] * 7 + [_P]),
    "ptt_conv3x3_wgmma_ld_bf16": (_I, [_I, _P, _P, _P, _P, _P] + [_I] * 7 + [_P]),
    # device, tiles_dtype, out_dtype, kh, kw, int[6] out: threads, ring stages, dynamic shared bytes,
    # blocks per SM, rectangle rows and columns of K1's cell route
    "ptt_grid_merge_cell_info": (_I, [_I, _I, _I, _I, _I, _P]),
    # rows, n -> 4-byte words of scratch
    "ptt_radix_sort_workspace": (_LL, [_LL, _LL]),
    "ptt_merge_sort_workspace": (_LL, [_LL, _LL]),
    # device, keys, payload, keys_out, payload_out, workspace, key_kind, rows, n, stream
    "ptt_radix_sort": (_I, [_I, _P, _P, _P, _P, _P, _I, _LL, _LL, _P]),
    "ptt_merge_sort": (_I, [_I, _P, _P, _P, _P, _P, _I, _LL, _LL, _P]),
    # device, int[4] out: pairs per tile, threads per block, shared bytes per block, blocks per SM
    "ptt_radix_sort_pass_info": (_I, [_I, _P]),
    # device, x, packed weights, bias, p0, p1, y, B, H, W, C, Ho, Wo, C_out, groups, kh, kw, stride,
    # pad top, pad left, K_pad, N_pad, N tile, epilogue mode, relu, route (ops/quantized.py _CONV_ROUTES), stream
    "ptt_qconv2d": (_I, [_I] + [_P] * 6 + [_I] * 19 + [_P]),
    # device, x, skip (or null), y, row taps, column taps, B, H, W, C, Cs, OH, OW,
    # route (ops/quantized.py _UPSAMPLE_ROUTES), int[4] tile of the banded route, stream
    "ptt_q_upsample": (_I, [_I] + [_P] * 5 + [_I] * 8 + [_P, _P]),
    # device, a, b, ma, mb, gate (or null), y, B, H * W, C, relu, route (ops/quantized.py _ADD_ROUTES), stream
    "ptt_q_add": (_I, [_I] + [_P] * 6 + [_I, _LL, _I, _I, _I, _P]),
    # device, int[6] out: pairs per chunk, threads per block, shared bytes per block, blocks per SM
    # of the chunk sort and of the merge, most runs merged at once
    "ptt_merge_sort_info": (_I, [_I, _P]),
}

_lock = threading.Lock()
_library = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


def build() -> Path:
    """Compile the kernels unless a build of the same sources and flags
    exists; return the shared library's path.  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it as
    ``<library>.log``."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libptt_kernels_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objects)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
        if all(rc == 0 for _, _, rc in results):
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc.stdout + proc.stderr, proc.returncode))
        out.with_name(out.name + ".log").write_text(
            "".join(" ".join(cmd) + "\n" + text for cmd, text, _ in results))
        failed = [(cmd, text, rc) for cmd, text, rc in results if rc != 0]
        if failed:
            cmd, text, rc = failed[0]
            raise RuntimeError(f"nvcc failed with exit code {rc} ({cmd[-1]}):\n{text}")
        os.replace(tmp, out)  # atomic: a concurrent build of the same sources is harmless
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is not None:  # every launch asks: no lock once it is loaded
        return _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


def check(err: int, kernel: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        message = library().ptt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({message})")


def stream_of(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device`` (a device or its
    index)."""
    return torch.cuda.current_stream(device).cuda_stream
