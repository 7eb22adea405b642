"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, then linked into one shared
library with a plain C interface, loaded with ctypes. The library
lives in ``_build/`` beside this file, named by a hash of the sources and
flags, so a fresh checkout builds it at first use and later processes reuse
it. Nothing is built when the package is imported: :func:`library` builds on
its first call, which only the kernel wrappers make, and only for CUDA
tensors. Processes started together (the ranks of a process group) serialize
the build on an ``fcntl`` lock file beside the library: the first builds, the
others wait and load what it built.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
# libcuda, for cuTensorMapEncodeTiled (the TMA maps of the wgmma kernels)
LINK_FLAGS = ["-lcuda"]

# storage dtype -> the C interface's dtype code (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT8_CODE = 2  # int8 operands of csrc/matmul_wgmma.cu and csrc/probe_attention_wgmma.cu

_lock = threading.Lock()
_lib = None
# what the last build did: seconds spent in nvcc (0.0 when the library was
# already built), the library path, and ptxas' register/shared-memory report
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit "
                           "(looked on PATH and in /usr/local/cuda/bin)")
    return path


def _declare(lib):
    lib.vitocm_attention_qkv.argtypes = [_I, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.vitocm_attention_qkv.restype = _I
    lib.vitocm_attention_qkv_wgmma.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P]
    lib.vitocm_attention_qkv_wgmma.restype = _I
    lib.vitocm_flash_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.vitocm_flash_fwd.restype = _I
    lib.vitocm_flash_bwd.argtypes = [_I, *[_P] * 10, _I, _I, _I, _P]
    lib.vitocm_flash_bwd.restype = _I
    lib.vitocm_flash_fwd_savep.argtypes = [_I, *[_P] * 6, _I, _I, _I, _I, _P]
    lib.vitocm_flash_fwd_savep.restype = _I
    lib.vitocm_flash_bwd_savep.argtypes = [_I, *[_P] * 11, _I, _I, _I, _I, _P]
    lib.vitocm_flash_bwd_savep.restype = _I
    lib.vitocm_fused_mlp.argtypes = [_I, _I, *[_P] * 13, _I, _I, _I, ctypes.c_float, _P]
    lib.vitocm_fused_mlp.restype = _I
    lib.vitocm_fused_mlp_wgmma.argtypes = [*[_P] * 11, *[_I] * 5, ctypes.c_float, _P]
    lib.vitocm_fused_mlp_wgmma.restype = _I
    lib.vitocm_fused_mlp_serve.argtypes = [_I, *[_P] * 11, _I, _I, _I, ctypes.c_float, _P]
    lib.vitocm_fused_mlp_serve.restype = _I
    lib.vitocm_fused_mlp_bwd.argtypes = [_I, *[_P] * 13, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.vitocm_fused_mlp_bwd.restype = _I
    lib.vitocm_ln_linear.argtypes = [_I, *[_P] * 6, _I, _I, _I, ctypes.c_float, _P]
    lib.vitocm_ln_linear.restype = _I
    lib.vitocm_ln_linear_bwd.argtypes = [_I, *[_P] * 10, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.vitocm_ln_linear_bwd.restype = _I
    lib.vitocm_histogram_u8.argtypes = [_P, ctypes.c_size_t, _P, _P]
    lib.vitocm_histogram_u8.restype = _I
    lib.vitocm_matmul.argtypes = [_I, _I, *[_P] * 6, _I, _I, _I, _P]
    lib.vitocm_matmul.restype = _I
    lib.vitocm_quantize_rows.argtypes = [_I, _P, _P, _P, _I, _I, _P]
    lib.vitocm_quantize_rows.restype = _I
    lib.vitocm_probe_attention.argtypes = [*[_I] * 6, *[_P] * 6, *[_I] * 5, ctypes.c_float, _P]
    lib.vitocm_probe_attention.restype = _I
    lib.vitocm_swiglu_gate.argtypes = [_I, _P, _P, ctypes.c_longlong, _I, _P]
    lib.vitocm_swiglu_gate.restype = _I
    lib.vitocm_layerscale_norm.argtypes = [_I, *[_P] * 7, _I, _I, ctypes.c_float, _P]
    lib.vitocm_layerscale_norm.restype = _I
    return lib


def _compile(srcs, so):
    """nvcc each source to an object, all at once, then link ``so``.
    Returns ptxas' report; raises RuntimeError with nvcc's output on failure."""
    objdir = f"{so}.{os.getpid()}.objs"
    os.makedirs(objdir, exist_ok=True)
    procs = []
    for src in srcs:
        obj = os.path.join(objdir, os.path.basename(src) + ".o")
        procs.append((src, obj, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                 text=True)))
    report, failed = [], []
    for src, _, p in procs:
        out = p.communicate()[0]
        report.append(out)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *[obj for _, obj, _ in procs],
                        *LINK_FLAGS], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
    shutil.rmtree(objdir, ignore_errors=True)
    return "".join(report)


def library():
    """The loaded kernel library; builds it on the first call. Raises
    RuntimeError when there is no CUDA device, no nvcc, or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("the port's CUDA kernels need a CUDA device; none is available")
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + f.read())
        so = os.path.join(BUILD_DIR, f"libvitocm_{h.hexdigest()[:16]}.so")
        log = so[:-3] + ".ptxas.txt"
        seconds = 0.0
        if not os.path.isfile(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(so + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if not os.path.isfile(so):  # else built by the holder before us
                        t0 = time.perf_counter()
                        report = _compile([s for s in srcs if s.endswith(".cu")], so)
                        seconds = time.perf_counter() - t0
                        with open(log, "w") as f:
                            f.write(report)
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        ptxas = open(log).read() if os.path.isfile(log) else ""
        build_info.update(seconds=seconds, path=so, ptxas=ptxas)
        _lib = _declare(ctypes.CDLL(so))
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """The current stream of ``device``, for a kernel launch. Every launch
    asks for it, so this is where a launch is refused when the tensors lie
    on another card than the calling thread's current device: the launchers
    set their kernels' attributes and query the device on the current one
    (``parallel.mesh.init_distributed`` sets it for each rank)."""
    device = torch.device(device)
    if device.index is not None and device.index != torch.cuda.current_device():
        raise RuntimeError(f"kernel launch on {device} while the current CUDA device is "
                           f"cuda:{torch.cuda.current_device()}: call "
                           f"torch.cuda.set_device({device.index}) first")
    return torch.cuda.current_stream(device).cuda_stream
