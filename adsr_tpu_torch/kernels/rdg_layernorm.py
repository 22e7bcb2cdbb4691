"""Kernel (a) ``rdg_layernorm``: LayerNorm over a prefix of the concat buffer.

Replaces the LayerNorm phases of the Pallas kernel ``_rdg_kernel_impl``
(``adsr_tpu/ops/fused_rdg.py:708-714, 860``). Source:
``adsr_tpu_torch/csrc/rdg_layernorm.cu``, templated on the element type:
bf16 instances and f32 ones (the fp32 serving forward, the TPU kernel at
dtype f32). Bound on the H100: bytes (one read and one write per element,
2 + 2 bytes in bf16, 4 + 4 in f32). Design: a group of lanes a row (a
half-warp for pieces of 4 values, two rows in flight a warp), the row in
registers in pieces of 4 values (8-byte bf16, 16-byte f32) or single values
as the layout allows (:func:`check_ln_layout`), gamma and beta loaded once
a lane, two-pass f32 statistics, the concat prefix read in place at its row
stride, and a grid of :func:`rdg_layernorm_plan`'s blocks looping over the
rows, the next row loaded while this one is normalised (see the source for
details).

``rdg_layernorm`` dispatches by device: a CPU tensor goes to
``rdg_layernorm_plain``, a CUDA tensor to the kernel of its dtype (bf16 or
f32; any other raises). The f32 launches count in ``launches_f32``, the
bf16 ones in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adsr_tpu_torch.kernels import _build

EPS = 1e-6
MAX_C = 320            # 20 values a lane of a half-warp
THREADS = 128          # 4 warps a block
# piece bytes -> lanes a row, as the source takes them (``kLanes``): a
# half-warp for pieces of 4 values (8 bytes in bf16, 16 in f32), a warp for
# single values (2 or 4 bytes)
LANES = {8: 16, 2: 32, 16: 16, 4: 32}


@functools.lru_cache(maxsize=None)
def blocks_per_sm(piece: int) -> tuple:
    """Blocks of ``THREADS`` an SM holds at once of the built kernel for
    ``piece`` bytes (8 and 2 the bf16 instances, 16 and 4 the f32 ones),
    without and with a row loaded ahead
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: what the registers
    ptxas gave each instance allow). Needs the card."""
    n = (ctypes.c_int * 2)()
    _build.check_rc("rdg_layernorm_blocks_per_sm",
                    _build.library().adsr_rdg_layernorm_blocks_per_sm(
                        piece, ctypes.addressof(n)))
    return tuple(n)


@functools.lru_cache(maxsize=None)
def rdg_layernorm_plan(m: int, c: int, sms: int, piece: int,
                       per_sm: tuple) -> dict:
    """What kernel (a) launches for ``m`` rows of width ``c`` (any width up
    to ``MAX_C`` takes the same registers) in pieces of ``piece`` bytes
    (:func:`check_ln_layout`): ``LANES[piece]`` lanes a row, so blocks of
    ``THREADS`` take ``rows_per_step`` rows a step; one row ahead where a
    block takes more than one step; as many blocks as the card holds at once
    (``per_sm``: :func:`blocks_per_sm` without and with a row ahead, on each
    of ``sms`` SMs) or one a step where fewer, so a small ``m`` spreads a
    step a block over every SM. Read only (cached)."""
    lanes = LANES[piece]
    rows_per_step = THREADS // lanes
    steps = -(-m // rows_per_step)
    ahead = int(steps > sms * per_sm[0])
    blocks = max(1, min(steps, sms * per_sm[ahead]))
    return {"piece": piece, "lanes": lanes, "ahead": ahead,
            "threads": THREADS, "rows_per_step": rows_per_step,
            "blocks": blocks, "steps_per_block": -(-steps // blocks)}


def check_ln_layout(name: str, x: torch.Tensor, out: torch.Tensor) -> int:
    """The kernel's layout rules, on tensor metadata only (no card needed),
    and the piece (bytes) it takes ``x`` and ``out`` [m, c] in: c from 1 to
    ``MAX_C``, unit column stride and (m > 1) a row stride of at least c,
    or the call raises; pieces of 4 values where both bases are aligned to
    the piece and c and both row strides are multiples of 4, single values
    otherwise. In bf16 that is 8-byte pieces (16-byte pieces of 8 values,
    where the rows allow them, read 4-28% slower on the H100: PERF.md §6)
    or 2-byte ones; in f32 16-byte (float4) or 4-byte ones."""
    m, c = x.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"{name}: the kernel takes widths from 1 to {MAX_C}, "
                         f"got {c}")
    for t in (x, out):
        if t.stride(-1) != 1 or (m > 1 and t.stride(0) < c):
            raise ValueError(f"{name}: needs unit column stride and a row "
                             f"stride of at least {c}, got strides "
                             f"{tuple(t.stride())}")
    size = x.element_size()
    if c % 4 == 0 and (x.data_ptr() | out.data_ptr()) % (4 * size) == 0 \
            and (x.stride(0) | out.stride(0)) % 4 == 0:
        return 4 * size
    return size


def rdg_layernorm_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """[M, c] (any row stride) -> f32 LayerNorm over the last axis."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def rdg_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  out: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """LayerNorm of ``x`` [M, c] (row stride >= c) into ``out`` [M, c]."""
    m, c = x.shape
    if out.shape != (m, c) or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"rdg_layernorm: shapes x {tuple(x.shape)}, "
                         f"out {tuple(out.shape)}, weight {tuple(weight.shape)}")
    if x.device.type == "cpu":
        out.copy_(rdg_layernorm_plain(x, weight, bias, eps))
        return out
    f32 = _build.require_cuda("rdg_layernorm", _build.BF16_F32, x, out,
                              layout=False) == torch.float32
    _build.require_f32_cuda("rdg_layernorm", weight, bias)
    piece = check_ln_layout("rdg_layernorm", x, out)
    plan = rdg_layernorm_plan(m, c, _build.sm_count(x.device), piece,
                              blocks_per_sm(piece))
    lib = _build.library()
    entry = lib.adsr_rdg_layernorm_f32 if f32 else lib.adsr_rdg_layernorm
    rc = entry(x.data_ptr(), x.stride(0), weight.data_ptr(), bias.data_ptr(),
               out.data_ptr(), out.stride(0), m, c, piece, plan["ahead"],
               plan["blocks"], eps, _build.stream_ptr(x))
    _build.check_rc("rdg_layernorm", rc)
    if f32:
        rdg_layernorm.launches_f32 += 1
    else:
        rdg_layernorm.launches += 1
    return out


rdg_layernorm.launches = 0
rdg_layernorm.launches_f32 = 0
