"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface, loaded through
``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``heal_swin_torch/_build/`` under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: :func:`lib` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # -v: registers/smem/spills per kernel
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "hs_window_attention_qkv_epi": ([_P] * 11 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention_qkv_epi_bwd": ([_P] * 16 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention_qkv_epi_bwd_workspace": ([_I] * 2, ctypes.c_size_t),
    "hs_window_attention_bwd": ([_P] * 8 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention_bwd_workspace": ([_I] * 2, ctypes.c_size_t),
    "hs_window_attention_qkv": ([_P] * 7 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention_qkv_epi_f32": ([_P] * 12 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention_qkv_epi_f32_workspace": ([_I] * 2, ctypes.c_size_t),
    "hs_window_attention_f32": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
    "hs_gemm_nn_f32": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "hs_window_attention_qkv_bwd": ([_P] * 11 + [_I] * 4 + [_F, _P], _I),
    "hs_window_attention_qkv_bwd_workspace": ([_I] * 2, ctypes.c_size_t),
    "hs_gemm_nt": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "hs_proj_ln_bwd": ([_P] * 8 + [_I] * 3 + [_F, _P], _I),
    "hs_proj_ln_bwd_workspace": ([_I] * 2, ctypes.c_size_t),
    "hs_final_head_predict": ([_P] * 7 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_predict_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_predict_f32": ([_P] * 7 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_predict_f32_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_loss": ([_P] * 10 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_loss_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_loss_grid": ([_I] * 4, _I),
    "hs_final_head_loss_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_final_head_loss_bwd": ([_P] * 12 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_loss_bwd_rows": ([_P] * 12 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_loss_bwd_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_loss_bwd_grid": ([_I] * 4, _I),
    "hs_final_head_loss_bwd_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_final_head_loss_f32": ([_P] * 10 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_loss_f32_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_loss_f32_grid": ([_I] * 4, _I),
    "hs_final_head_loss_f32_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_final_head_loss_bwd_f32": ([_P] * 11 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_loss_bwd_f32_rows": ([_P] * 11 + [_I] * 4 + [_F, _P], _I),
    "hs_final_head_loss_bwd_f32_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_loss_bwd_f32_grid": ([_I] * 4, _I),
    "hs_final_head_loss_bwd_f32_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_reduce_rows": ([_P] * 3 + [_I] * 2 + [_P], _I),
    "hs_reduce_rows_workspace": ([_I] * 2, ctypes.c_size_t),
    "hs_gemm_tn": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "hs_gemm_tn_workspace": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_depth_loss": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "hs_final_head_depth_loss_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_depth_loss_grid": ([_I] * 4, _I),
    "hs_final_head_depth_loss_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_final_head_depth_loss_bwd": ([_P] * 11 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "hs_final_head_depth_loss_bwd_rows": ([_P] * 11 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "hs_final_head_depth_loss_bwd_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_depth_loss_bwd_grid": ([_I] * 4, _I),
    "hs_final_head_depth_loss_bwd_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_final_head_depth_loss_f32": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "hs_final_head_depth_loss_f32_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_depth_loss_f32_grid": ([_I] * 4, _I),
    "hs_final_head_depth_loss_f32_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_final_head_depth_loss_bwd_f32": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "hs_final_head_depth_loss_bwd_f32_rows": ([_P] * 10 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "hs_final_head_depth_loss_bwd_f32_smem": ([_I] * 3, ctypes.c_size_t),
    "hs_final_head_depth_loss_bwd_f32_grid": ([_I] * 4, _I),
    "hs_final_head_depth_loss_bwd_f32_workspace": ([_I] * 4, ctypes.c_size_t),
    "hs_chamfer_min_both": ([_P] * 4 + [_I] * 2 + [_P], _I),
    "hs_chamfer_fold_pairs": ([_P, _I] + [_P] * 4 + [_I] * 2 + [_P], _I),
    "hs_mlp_fwd": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "hs_mlp_block_fwd": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
    "hs_mlp_bwd": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "hs_mlp_bwd_workspace": ([_I] * 3, ctypes.c_size_t),
    "hs_mlp_bwd_splits": ([_I] * 3, _I),
    "hs_mlp_bwd_dx": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "hs_mlp_bwd_dw": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "hs_mlp_block_bwd": ([_P] * 14 + [_I] * 5 + [_F, _P], _I),
    "hs_mlp_block_bwd_workspace": ([_I] * 3, ctypes.c_size_t),
    "hs_mlp_block_bwd_du": ([_P] * 11 + [_I] * 5 + [_F, _P], _I),
    "hs_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build (None: loaded as built)
build_log: str = ""  # nvcc's output of the last build (-Xptxas -v register/smem report)


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their output, or raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def _compile(target: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / (p.stem + ".o")) for p in sorted(SRC_DIR.glob("*.cu"))]
        log = _run([[nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(p), "-o", o]
                    for p, o in zip(sorted(SRC_DIR.glob("*.cu")), objs)])
        so = str(Path(tmpdir) / "lib.so")
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]])
        os.replace(so, target)  # atomic: a concurrent process never loads a partial file
    build_seconds = time.perf_counter() - t0
    build_log = log


def lib() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libheal_swin_kernels_{_digest()}.so"
            if not target.exists():
                _compile(target)
            handle = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
        return _lib
