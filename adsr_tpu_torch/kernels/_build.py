"""Build and load the hand-written Hopper kernels (``adsr_tpu_torch/csrc``).

Route: ``nvcc`` compiles each ``.cu`` file of ``csrc/`` for ``sm_90a`` into an
object, all sources at once in parallel, then links them into one shared
library with a plain C interface, loaded with ``ctypes``. No source includes
PyTorch's headers, so a cold build takes seconds, not minutes.

The library lands in ``build/adsr_tpu_torch/<hash>/`` beside the package
(``.gitignore`` lists ``build/``); the hash covers every source and flag, so a
changed source rebuilds and an unchanged one is loaded as it is. Nothing here
runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "adsr_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "libadsr_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes; each returns cudaGetLastError() as int
SIGNATURES = {
    # x, ldx, weight, bias, y, ldy, M, C, piece, ahead, blocks, eps, stream
    "adsr_rdg_layernorm": [_P, _L, _P, _P, _P, _L] + [_I] * 5 + [_F, _P],
    # piece, int* out: blocks an SM holds without and with a row ahead
    "adsr_rdg_layernorm_blocks_per_sm": [_I, _P],
    # A, lda, W, ldw, bias, out, ldo, res, ldr, row_scale, scale_stride,
    # rows_per_scale, aux, ldaux, M, N, K, epilogue, bn, stream
    "adsr_rdg_gemm": [_P, _L, _P, _L, _P, _P, _L, _P, _L, _P, _L, _I, _P, _L,
                      _I, _I, _I, _I, _I, _P],
    # qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, win, shift, smem,
    # stream
    "adsr_window_attention": [_P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _L, _P],
    # dy, ldy, dy_f32, alpha, slope, lds, scale, scale_stride, rows_per_scale,
    # W, ldw, pre, ldp, out, ldo, out_f32, A, lda, eff, lde, part, db_part,
    # splits, rows_per_split, dW, db, M, N, K, bn, stream (a null out skips
    # dgrad, a null dW wgrad)
    "adsr_rdg_gemm_grads": [_P, _L, _I, _F, _P, _L, _P, _L, _I, _P, _L, _P,
                            _L, _P, _L, _I, _P, _L, _P, _L, _P, _P, _I, _I,
                            _P, _P, _I, _I, _I, _I, _P],
    # x, ldx, dy, ldy, w, dres, ldr, dx, ldo, part, dgamma, dbeta, M, C,
    # blocks, eps, stream
    "adsr_rdg_layernorm_bwd": [_P, _L, _P, _L, _P, _P, _L, _P, _L, _P, _P,
                               _P, _I, _I, _I, _F, _P],
    # qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C,
    # nh, win, shift, group, smem, stream
    "adsr_window_attention_bwd": [_P, _L, _P, _L, _P, _P, _P, _L, _P, _P]
                                 + [_I] * 8 + [_L, _P],
    # qkv, ldq, ctx, ldc, bias, mask, stats, B, H, W, C, nh, shift, smem,
    # stream (16x16 windows)
    "adsr_window_attention16": [_P, _L, _P, _L, _P, _P, _P] + [_I] * 6
                               + [_L, _P],
    # qkv, ldq, dctx, ldg, ctx, ldc, bias, mask, stats, dqkv, ldd, stats4,
    # part, dbias, B, H, W, C, nh, shift, group, smem_dq, smem_dkv, stream
    # (16x16 windows)
    "adsr_window_attention_bwd16": [_P, _L, _P, _L, _P, _L, _P, _P, _P, _P,
                                    _L, _P, _P, _P] + [_I] * 7
                                   + [_L, _L, _P],
    # x, ldx, out, ldo, ln1_w, ln1_b, wqkv, ld_qkv, bqkv, bias, mask, wproj,
    # ld_proj, bproj, ln2_w, ln2_b, w1, ld1, b1, w2, ld2, b2, B, H, W, C, F,
    # nh, win, shift, stages, eps, smem, stream
    "adsr_swin_block": [_P, _L, _P, _L, _P, _P, _P, _L, _P, _P, _P, _P, _L,
                        _P, _P, _P, _P, _L, _P, _P, _L, _P] + [_I] * 9
                       + [_F, _L, _P],
}
# qkv, ldq, ctx, ldc, bias, mask, B, H, W, C, nh, shift, stages, grid, smem,
# stream (4x4 windows)
SIGNATURES["adsr_window_attention4"] = [_P, _L, _P, _L, _P, _P] + [_I] * 8 \
    + [_L, _P]
# qkv, ldq, dctx, ldg, bias, mask, dqkv, ldd, part, dbias, B, H, W, C, nh,
# shift, stages, grid, smem, stream (4x4 windows)
SIGNATURES["adsr_window_attention_bwd4"] = [_P, _L, _P, _L, _P, _P, _P, _L,
                                            _P, _P] + [_I] * 8 + [_L, _P]
# (g) at 16x16 windows (swin_block16.cu) and at 4x4 (swin_block4.cu):
# adsr_swin_block's arguments with ``cluster`` (blocks a window or a group)
# after ``stages``
SIGNATURES["adsr_swin_block16"] = SIGNATURES["adsr_swin_block"][:31] \
    + [_I] + SIGNATURES["adsr_swin_block"][31:]
SIGNATURES["adsr_swin_block4"] = SIGNATURES["adsr_swin_block16"]
# hd, smem, int* out: the clusters the card holds at once
SIGNATURES["adsr_swin_block16_clusters"] = [_I, _L, _P]
# the f32 instances of (a), (b) and (c) (the fp32 serving forward):
# (a)'s arguments as adsr_rdg_layernorm's (piece 16 or 4 bytes); (b)'s as
# adsr_rdg_gemm's without the tile width; (c)'s as adsr_window_attention's,
# one entry a window (8x8, 4x4, 16x16)
SIGNATURES["adsr_rdg_layernorm_f32"] = SIGNATURES["adsr_rdg_layernorm"]
SIGNATURES["adsr_rdg_gemm_f32"] = SIGNATURES["adsr_rdg_gemm"][:18] + [_P]
for _name in ("adsr_window_attention_f32", "adsr_window_attention4_f32"):
    SIGNATURES[_name] = SIGNATURES["adsr_window_attention"]
# (c) f32 at 16x16 windows: adsr_window_attention's with the softmax
# statistics after ``mask`` (null for none)
SIGNATURES["adsr_window_attention16_f32"] = \
    SIGNATURES["adsr_window_attention"][:6] + [_P] \
    + SIGNATURES["adsr_window_attention"][6:]
# the f32 instances of (d), (e) and (f) (fp32 training): (e)'s arguments as
# adsr_rdg_layernorm_bwd's; (f)'s as the bf16 entries' of each window
SIGNATURES["adsr_rdg_layernorm_bwd_f32"] = SIGNATURES["adsr_rdg_layernorm_bwd"]
for _name in ("adsr_window_attention_bwd_f32",
              "adsr_window_attention_bwd4_f32"):
    SIGNATURES[_name] = SIGNATURES["adsr_window_attention_bwd"]
SIGNATURES["adsr_window_attention_bwd16_f32"] = \
    SIGNATURES["adsr_window_attention_bwd16"]
# (d): dy, ldy, alpha, slope, lds, scale, scale_stride, rows_per_scale, W,
# ldw, pre, ldp, out, ldo, A, lda, eff, lde, part, db_part, splits,
# rows_per_split, dW, db, M, N, K, stream (a null out skips dgrad, a null
# dW wgrad)
# (g)'s f32 instances, a source a window (swin_block{4,,16}_f32.cu): the
# arguments of adsr_swin_block16 at every window
for _name in ("adsr_swin_block_f32", "adsr_swin_block4_f32",
              "adsr_swin_block16_f32"):
    SIGNATURES[_name] = SIGNATURES["adsr_swin_block16"]
SIGNATURES["adsr_rdg_gemm_grads_f32"] = [_P, _L, _F, _P, _L, _P, _L, _I, _P,
                                         _L, _P, _L, _P, _L, _P, _L, _P, _L,
                                         _P, _P, _I, _I, _P, _P, _I, _I, _I,
                                         _P]


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the CUDA "
                           "kernels build only on a machine with the toolkit")
    return found


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join([nvcc] + NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Build the library if its sources changed, and return its path."""
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / _digest(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                                   str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        failed = []
        for src, proc in zip(sources(), procs):
            text, _ = proc.communicate()      # every compile runs meanwhile
            (out_dir / (src.stem + ".log")).write_text(text)
            if proc.returncode:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for obj in objs]],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib


def build_log() -> str:
    """What ptxas said about each kernel (registers, shared memory, spills)."""
    lib = library_path()
    return "\n".join(p.read_text() for p in sorted(lib.parent.glob("*.log")))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s CUDA device: one call
    into torch's C core (``torch.cuda.current_stream`` builds a Stream
    object and looks the device up twice, ~9 us a launch on the H100's
    host)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


BF16 = (torch.bfloat16,)
BF16_F32 = (torch.bfloat16, torch.float32)
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def kernel_dtype(name: str, dtypes: tuple,
                 *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of ``tensors`` if it is among ``dtypes`` (``BF16``, or
    ``BF16_F32``: every kernel of the port has bf16 and f32 instances),
    else ``NotImplementedError`` naming what the kernels take."""
    got = {t.dtype for t in tensors}
    if len(got) != 1 or not got <= set(dtypes):
        takes = " or ".join(_DTYPE_NAMES[d] for d in dtypes)
        raise NotImplementedError(
            f"{name}: the CUDA kernels take {takes} (all operands of one "
            f"type), got {sorted(map(str, got))} (on the CPU the "
            "plain path takes any float type)")
    return got.pop()


def require_cuda(name: str, dtypes: tuple, *tensors: torch.Tensor,
                 layout: bool = True) -> torch.dtype:
    """The wrappers' input check for the kernel route, and the one dtype of
    ``tensors``: every tensor on CUDA (checked first, else ``ValueError``),
    of one dtype among ``dtypes`` (:func:`kernel_dtype`). ``layout=False``
    leaves unit column stride and alignment to the caller's own layout
    check."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, kernel needs CUDA")
    dtype = kernel_dtype(name, dtypes, *tensors)
    for t in tensors:
        if layout and (t.stride(-1) != 1 or t.data_ptr() % 8):
            raise ValueError(f"{name}: needs unit column stride and an 8-byte "
                             "aligned base pointer")
    return dtype


def require_f32_cuda(name: str, *tensors: torch.Tensor,
                     contiguous: bool = True) -> None:
    """float32 on CUDA; ``contiguous=False`` takes any strides (the kernel
    is given them), but still an aligned base pointer."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or (contiguous and not t.is_contiguous()) \
                or t.data_ptr() % 4:
            raise ValueError(f"{name}: tensors must be "
                             f"{'contiguous ' if contiguous else ''}float32 "
                             f"on CUDA, got {t.dtype} on {t.device}")


def operand_paths(kernel: str) -> ctypes.Array:
    """[TMA, cp.async]: how many GEMM operands of ``kernel``'s launches
    (``"rdg_gemm"`` or ``"rdg_gemm_bwd"``) went by each path since the count
    was last set to 0 (the array is writable)."""
    return (ctypes.c_longlong * 2).in_dll(library(), f"adsr_{kernel}_operands")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (the persistent GEMMs' grid)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
