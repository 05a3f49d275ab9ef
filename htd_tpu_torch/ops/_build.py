"""Build and load the port's CUDA kernels and its host library.

The sources in `htd_tpu_torch/csrc/*.cu` have a plain C interface and no
PyTorch headers. Each is compiled by its own `nvcc` process (all started
together) for `sm_90a`, then linked into one shared library that `ctypes`
loads. The library lands in `htd_tpu_torch/_build/<hash>/`, keyed by a
hash of the sources and flags, so a checkout builds it at first use and
reuses it afterwards.

The host code in `csrc/*.cpp` (the JPEG decoder and encoder, OpenCV's
float32 filters and warps, the COCO matcher, the text rasteriser) is built
apart, by the host's C++ compiler (`$CXX`, else `c++` on `PATH`), into
`_build/host-<hash>/`, with `-ffp-contract=off` so that no product and sum
are fused where OpenCV keeps them apart; it needs no CUDA. Nothing here runs
at import time.

The launchers (`ops/*_cuda.py`) share `DTYPE_CODE`, `launch_stream` and
`check_launch` beside `load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]
# the dtype argument of the kernels' C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class BuildInfo(NamedTuple):
    """What `build` did: the library, seconds spent, whether it compiled,
    and nvcc's messages."""
    path: Path
    seconds: float
    built: bool
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> BuildInfo:
    """Compile the kernels unless this exact build exists; return its info."""
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libhtd_kernels.so"
    if lib.exists():
        return BuildInfo(lib, time.perf_counter() - t0, False, "")
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            cmds.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)])
        log = _run_all(cmds)
        tmp_lib = Path(tmp) / lib.name
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                          "-o", str(tmp_lib), *objs]])
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib)
    return BuildInfo(lib, time.perf_counter() - t0, True, log)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f32p, i32p = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p
    lib.htd_pyramid_pack.argtypes = [vp, vp, i32p, i32p, i32p, i32, i32, i32, i32, i32,
                                     i32, vp]
    lib.htd_pyramid_pack.restype = i32
    lib.htd_roi_align_fwd.argtypes = [vp, f32p, i32p, vp, i32, i32, f32p, i32p, i32p,
                                      i32p, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.htd_roi_align_fwd.restype = i32
    lib.htd_roi_align_bwd.argtypes = [vp, f32p, i32p, vp, i32, i32, f32p, i32p, i32p,
                                      i32p, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.htd_roi_align_bwd.restype = i32
    lib.htd_deform_conv_fwd.argtypes = [vp, vp, vp, vp] + [i32] * 13 + [vp]
    lib.htd_deform_conv_fwd.restype = i32
    lib.htd_deform_conv_bwd_input.argtypes = [vp] * 5 + [i32] * 13 + [vp]
    lib.htd_deform_conv_bwd_input.restype = i32
    lib.htd_deform_conv_bwd_offset_weight.argtypes = [vp] * 6 + [i32] * 13 + [vp]
    lib.htd_deform_conv_bwd_offset_weight.restype = i32
    lib.htd_deform_conv_bwd_dw_partials.argtypes = [i32] * 7
    lib.htd_deform_conv_bwd_dw_partials.restype = i32
    lib.htd_upsample_add.argtypes = [vp, vp, vp] + [i32] * 5 + [vp]
    lib.htd_upsample_add.restype = i32
    lib.htd_layout_fence.argtypes = [vp, vp, ctypes.c_longlong, vp]
    lib.htd_layout_fence.restype = i32
    f32 = ctypes.c_float
    lib.htd_soft_nms.argtypes = [vp, vp, i32, f32, f32, i32, vp, vp, vp, vp, vp]
    lib.htd_soft_nms.restype = i32
    lib.htd_nms.argtypes = [vp, vp, vp, i32, f32, i32, vp, vp, vp, vp, vp]
    lib.htd_nms.restype = i32


def _host_compiler() -> List[str]:
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    found = shutil.which("c++")
    if found:
        return [found]
    raise RuntimeError("no host C++ compiler: set CXX, or put c++ on PATH (the host "
                       "library, htd_tpu_torch/csrc/*.cpp, needs one)")


def build_host() -> BuildInfo:
    """Compile the host library from `csrc/*.cpp` unless this exact build
    exists; return its info. Concurrent builds (test workers) each compile
    to a name of their own and move it into place."""
    t0 = time.perf_counter()
    cxx = _host_compiler()
    sources = sorted(CSRC.glob("*.cpp"))
    h = hashlib.sha256(" ".join(cxx + HOST_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / "libhtd_host.so"
    if lib.exists():
        return BuildInfo(lib, time.perf_counter() - t0, False, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so")
    os.close(fd)
    try:
        cmd = [*cxx, *HOST_FLAGS, *map(str, sources), "-o", tmp]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"the host C++ compiler {cxx[0]!r} (from CXX or PATH) was "
                               f"not found") from e
        if proc.returncode != 0:
            raise RuntimeError(f"host build failed:\n{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildInfo(lib, time.perf_counter() - t0, True, proc.stdout)


@functools.lru_cache(maxsize=None)
def load_host() -> Tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the host library, once per process."""
    info = build_host()
    lib = ctypes.CDLL(str(info.path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.htd_jpeg_header.argtypes = [vp, i64, vp]
    lib.htd_jpeg_header.restype = ctypes.c_int
    lib.htd_jpeg_decode.argtypes = [vp, i64, vp, i32, i32]
    lib.htd_jpeg_decode.restype = ctypes.c_int
    lib.htd_jpeg_reconstruct.argtypes = [i32, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.htd_jpeg_reconstruct.restype = ctypes.c_int
    lib.htd_sep_filter_f32.argtypes = [vp, i32, i32, i32, vp, i32, vp, i32, i32, vp]
    lib.htd_filter2d_f32.argtypes = [vp, i32, i32, i32, vp, i32, i32, i32, vp]
    lib.htd_warp_affine_f32.argtypes = [vp, i32, i32, i32, vp, i32, i32, i32, vp]
    lib.htd_remap_f32.argtypes = [vp, i32, i32, i32, vp, vp, i32, i32, i32, vp]
    lib.htd_resize_linear_f32.argtypes = [vp, i32, i32, i32, i32, i32, vp]
    for fn in (lib.htd_sep_filter_f32, lib.htd_filter2d_f32, lib.htd_warp_affine_f32,
               lib.htd_remap_f32, lib.htd_resize_linear_f32):
        fn.restype = ctypes.c_int
    f64 = ctypes.c_double
    lib.htd_coco_match.argtypes = [vp, vp, i64, vp, vp, i64, f64, f64, vp, i64, vp, vp, vp]
    lib.htd_coco_match.restype = i64
    lib.htd_jpeg_forward.argtypes = [vp, i32, i32, i64, vp, vp, vp, vp]
    lib.htd_jpeg_forward.restype = ctypes.c_int
    lib.htd_jpeg_encode.argtypes = [i32, i32, vp, vp, vp, vp, vp, i64]
    lib.htd_jpeg_encode.restype = i64
    lib.htd_text_glyph.argtypes = [vp, i32, i32, i32, i64, vp, vp, i32, ctypes.c_float, i32,
                                   i32, i32, i32, i32, i32, vp]
    lib.htd_text_glyph.restype = ctypes.c_int
    return lib, info


def launch_stream() -> int:
    """PyTorch's current CUDA stream, which every launch goes on."""
    return torch.cuda.current_stream().cuda_stream


def check_launch(err: int, name: str) -> None:
    """Raise when the C entry point of kernel `name` returned an error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error code {err}")


@functools.lru_cache(maxsize=None)
def load() -> Tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the kernel library, once per process."""
    info = build()
    lib = ctypes.CDLL(str(info.path))
    _declare(lib)
    return lib, info
