"""Builds the hand-written CUDA kernels under `sam6d_torch/csrc/` and binds
them with ctypes.

Each `*.cu` source compiles with its own nvcc process, all started together,
and the objects link into ONE shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), at first use, into
`sam6d_torch/_build/` (git-ignored). The file name carries a hash of the
sources and of the headers they include (`*.cuh`), so an edited kernel or
header is rebuilt and a stale library is never loaded.
Wrappers pass `tensor.data_ptr()` and `torch.cuda.current_stream().cuda_stream`
as `c_void_p`; every C entry point returns the launch's `cudaGetLastError()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)   # host array of device pointers
_IP = ctypes.POINTER(ctypes.c_int)      # host array of ints
_LP = ctypes.POINTER(ctypes.c_longlong)  # host array of 64-bit strides
_SIGNATURES = {
    "sam6d_fps_block": [_P, _P, _I, _I, _I, _P, _P],
    "sam6d_fps_cluster": [_P, _P, _I, _I, _I, _P, _P],
    "sam6d_fps_cluster_occupancy": [_I, _IP, _IP, _IP],
    "sam6d_fps_multi_block": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "sam6d_fps_latency": [_I, _I, _I, _P, _P],
    "sam6d_two_scale_ball_query": [_P, _P, _I, _I, _I, _F, _I, _F, _I, _I, _P,
                                   _P, _P],
    "sam6d_fused_attention_qkv": [_P, _P, _I, _I, _I, _I, _F, _P],
    "sam6d_fused_attention": [_P, _P, _P, _P, _LP, _LP, _LP, _LP, _I, _I, _I, _I,
                              _I, _F, _P],
    "sam6d_fused_attention_small": [_P, _P, _P, _P, _LP, _LP, _LP, _I, _I, _I,
                                    _I, _F, _P],
    "sam6d_flash_attention_relpos": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _P],
    "sam6d_fused_attention_qkv_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    "sam6d_fused_attention_qkv_bf16_smem": [_I, _I],
    "sam6d_fused_attention_bf16": [_P, _P, _P, _P, _LP, _LP, _LP, _LP, _I, _I,
                                   _I, _I, _I, _F, _P],
    "sam6d_fused_attention_small_bf16": [_P, _P, _P, _P, _LP, _LP, _LP, _I, _I,
                                         _I, _I, _F, _P],
    "sam6d_flash_attention_relpos_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _F, _P],
    "sam6d_flash_attention_relpos_bf16_smem": [_I, _I, _I, _I],
    "sam6d_factored_ln_stats": [_PP, _PP, _IP, _I, _P, _P, _P, _P, _I, _I, _I,
                                _I, _F, _P],
    "sam6d_factored_t2i_workspace": [_I, _I],
    "sam6d_factored_t2i_attention": [_P, _P, _P, _PP, _PP, _IP, _I, _P, _P, _P,
                                     _P, _P, _P, _I, _I, _I, _I, _P],
    "sam6d_factored_i2t_scores": [_P, _P, _PP, _PP, _IP, _I, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _P],
    "sam6d_factored_ln_stats_bf16": [_PP, _PP, _IP, _I, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _F, _P],
    "sam6d_factored_t2i_bf16_workspace": [_IP, _I, _I],
    "sam6d_factored_t2i_attention_bf16": [_P, _P, _P, _PP, _PP, _IP, _I, _P, _P,
                                          _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sam6d_factored_i2t_scores_bf16": [_P, _P, _PP, _PP, _IP, _I, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _P],
}

_lib = None


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(csrc: Path = CSRC_DIR) -> Path:
    """The library built from the `.cu` sources and `.cuh` headers in
    `csrc`: its name changes when any of their bytes do."""
    digest = hashlib.sha256()
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsam6d_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels if the library for the current sources is missing:
    one nvcc per source, in parallel, then one link. Returns (library path,
    compiler output); `verbose` adds `-Xptxas -v` (registers, shared memory
    and spills per kernel)."""
    so = library_path()
    if so.exists() and not verbose:
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    outputs = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, _, proc in jobs]
    objs = [obj for _, obj, _ in jobs]
    try:
        for cmd, text, rc in outputs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so, "".join(text for _, text, _ in outputs)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call in this process."""
    global _lib
    if _lib is None:
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {err}")
