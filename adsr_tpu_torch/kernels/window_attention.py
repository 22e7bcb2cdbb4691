"""Kernel (c) ``window_attention``: shifted-window MSA over the raster qkv.

Replaces the attention phases of the Pallas kernel ``_rdg_kernel_impl``
(``adsr_tpu/ops/fused_rdg.py:734-855``). Source:
``adsr_tpu_torch/csrc/window_attention.cu`` on the attention core of
``csrc/window_attn_core.cuh`` (shared with kernel (g)). Bound on the H100:
bytes (qkv is read once, the context written once; the 64-token products
are cheap). Design: one small block per (image, window, head), several to
an SM, reads the pieces of the window's 64 qkv rows that hold its head in
16-byte loads (``qkv`` and ``out`` have 16-byte rows: row strides that are
multiples of 8 elements, as ``kernels/rdg_gemm.py`` ``pitched`` lays them
out) into q/k/v planes in shared memory (head dims zero-padded to a
multiple of 16); each warp runs the register-resident core (mma.sync
scores, bias and mask, stabilised f32 softmax, P @ V) on 16 query rows; the
context goes back in 16-byte stores. At 4x4 windows (N = 16,
``csrc/window_attention4.cu`` on ``csrc/attn4.cuh``) a block takes every
head of its windows: it stages whole token rows by ``cp.async`` (a ring of
``stages`` windows on a persistent grid, :func:`plan4`), one warp a head
holds the whole window (16 query rows against 16 keys) and reads q, k and
v in place from the staged rows, and whole rows of the context go back in
16-byte stores. At 16x16 windows (N =
256, ``csrc/window_attention16.cu`` on ``csrc/attn16.cuh``) one block of two
warpgroups per (image, window, head) gathers the window's K and V once
into swizzled tiles and each warpgroup walks them for two of the four
64-row query tiles on ``wgmma``, FlashAttention-2's online softmax:
exp(S - running max) rounded once to bf16 as the register A of P @ V, the
f32 context rescaled as the max grows and divided by the row sum at the
end; with ``stats`` it also writes each query row's (max, 1 / sum), which
kernel (f) reads (:func:`softmax_stats`). The cyclic shift is index
arithmetic on raster rows, so nothing is rolled or gathered in memory; the
softmax is the stabilised f32 one (the TPU kernel's unstabilised exp2 form,
its score-bound guard and its window pairs with -1e30 off-diagonal terms
are not carried over).

f32 operands go to a kernel of their own, ``csrc/window_attention_tc_f32.cuh``
(the TPU kernel at dtype f32), templated on N = 16, 64 and 256 and the
padded head dim (one source a window: ``window_attention4_f32.cu``,
``window_attention_f32.cu``, ``window_attention16_f32.cu``), every product
f32-accurate as 3xTF32 on the tensor cores (``mma.sync``; each value split
into hi = x with its low 13 bits cleared and lo = x - hi, three products a
pair): a block of
min(N, 64) / 16 warps per (image, window, head, query tile of min(N, 64)
rows), each warp 16 query rows, walks the window's keys in tiles of
min(N, 64) with FlashAttention-2's online softmax in registers (``expf``; P
stays f32 and feeds P @ V from the accumulators), the bias and mask in the
forms :func:`attn_operands` gives (:func:`window_attention_f32_plan`). At
``TILED_WINDOWS`` it writes each query row's softmax statistics when given
a ``stats`` buffer, as the bf16 kernel does (fp32 training's recompute;
kernel (f) f32 reads them). Its launches count in
``window_attention.launches_f32``, the bf16 ones in ``launches``.

Also here, for packing and the plain version: the additive attention term
(relative-position bias plus shift mask) in its per-window form, the JAX
``build_attn_term`` (``adsr_tpu/ops/fused_swin_block.py:157``) without pair
grouping.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.models.drct import (relative_position_index,
                                        shift_region_labels,
                                        window_attention_eager,
                                        window_partition, window_reverse)

KERNEL_WINDOW = 8      # the CUDA kernel's first window: 8x8 (N = 64)
KERNEL_WINDOWS = (4, 8, 16)  # the windows it takes: N = 16, 64 and 256
KEY_TILE = 64          # keys (and query rows) a tile at N = 256
THREADS = 128          # 4 warps a block, 16 query rows each
GROUP4 = 4             # windows a block of kernel (g) at 4x4 windows
# (c) and (f) at 4x4 windows (N = 16; csrc/attn4.cuh): a block of WARPS4
# warps takes every head of its windows (at most WARPS4 at once), on a ring
# of at most MAX_STAGES4 staged windows; the sources' __launch_bounds__ keep
# a thread within REGISTERS4
WARPS4 = 8
MAX_STAGES4 = 3
REGISTERS4 = 128
TILE_BYTES4 = 16 * 16 * 4  # a window's f32 mask, a head's f32 bias
BWD_TILE_LD4 = 24      # (f)'s bf16 P and dS tiles [16][24] a head slot
SMS = 132              # the H100's SMs
THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32  # resident blocks an SM holds at most
WARPGROUPS16 = 2       # consumer warpgroups a block at N = 256
# the windows whose kernels walk 64-token tiles on wgmma (N = 256): they
# take the bias as its table and the shift mask as region labels, and (c)
# writes the softmax statistics that (f) reads
TILED_WINDOWS = (16,)
MASK_OFF = -100.0      # the shift mask between tokens of different regions
REL_TABLE_BYTES = -(-31 * 31 * 4 // 16) * 16   # a 16x16 window's table
LABEL_BYTES = 256 * 4  # a 16x16 window's region labels (int32)
SWIZZLE_COLS = 64      # head dims a 128-byte swizzle row holds (bf16)
ALIGN_SLACK = 1024     # the N = 256 kernels align their tiles to 1024 bytes
SM_SHARED_BYTES = 233472     # an H100 SM's shared memory
BLOCK_SHARED_MAX = 232448    # the most one block may take
BLOCK_RESERVED = 1024        # what the runtime keeps per resident block
REGISTERS = 65536            # 32-bit registers an SM
F32_THREADS = 256            # a block of (f) f32 (window_attention_bwd.py)
TC_WARP_ROWS = 16            # query rows a warp of (c) f32
# the f32 kernel's C entry a window (a source a window, built in parallel)
F32_ENTRIES = {8: "adsr_window_attention_f32", 4: "adsr_window_attention4_f32",
               16: "adsr_window_attention16_f32"}


def windows_text() -> str:
    """'4x4, 8x8 or 16x16 windows': the windows the CUDA kernels take
    (``KERNEL_WINDOWS``), for their refusal messages."""
    names = [f"{w}x{w}" for w in KERNEL_WINDOWS]
    return f"{', '.join(names[:-1])} or {names[-1]} windows"


def head_tile(hd: int) -> int:
    """The head dim a plane holds: ``hd`` zero-padded to a multiple of 16
    (the mma k and n steps)."""
    return -(-hd // 16) * 16


def raw_pitch(width: int) -> int:
    """Elements a staged token row of ``width`` takes at 4x4 windows
    (``csrc/attn4.cuh`` ``raw_pitch``): 32-byte pieces and 16 bytes more."""
    return -(-width // 16) * 16 + 8


def attn4_smem(c: int, nh: int, stages: int, bwd: bool = False) -> int:
    """Shared memory of one block of (c) (or, ``bwd``, (f)) at 4x4 windows,
    as the sources lay it out: the heads' f32 bias (and (f)'s d(bias)
    accumulators), ``stages`` staged windows (the mask, 16 rows of qkv and,
    for (f), 16 of dO), and for (f) the output rows [16][3c] and each head
    slot's bf16 P and dS tiles [2][16][24]."""
    stage = TILE_BYTES4 + 16 * 2 * (raw_pitch(3 * c)
                                    + (raw_pitch(c) if bwd else 0))
    if not bwd:
        return nh * TILE_BYTES4 + stages * stage
    return 2 * nh * TILE_BYTES4 + stages * stage \
        + 16 * 2 * raw_pitch(3 * c) \
        + min(nh, WARPS4) * 2 * 16 * BWD_TILE_LD4 * 2


def plan4(c: int, nh: int, b: int, h: int, w: int, sms: int,
          bwd: bool = False) -> dict:
    """The launch of (c) (or, ``bwd``, (f)) at 4x4 windows: a block of
    ``WARPS4`` warps takes every head of one window at a time (``group``
    1; a warp a head, (f) two for four heads or fewer) and walks windows
    blockIdx.x, + ``grid``, ... over the flat (image, window) index,
    staging the next ``stages`` - 1 while it computes one. Where the card
    holds a block for
    every window (``blocks_per_sm`` by shared memory, threads and the
    sources' ``__launch_bounds__`` registers, ``REGISTERS4`` a thread), one
    window a block and one stage; else a persistent grid of every block the
    card holds, at the stages (2 or 3) that keep the most windows in
    flight. (f) writes one d(bias) partial [nh][16][16] a block."""
    hdp, warps = head_tile(c // nh), WARPS4
    threads, regs = 32 * warps, REGISTERS4
    windows = b * (h // 4) * (w // 4)

    def per_sm(stages):
        smem = attn4_smem(c, nh, stages, bwd)
        if smem > BLOCK_SHARED_MAX:
            return 0
        return min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED),
                   THREADS_PER_SM // threads, REGISTERS // (threads * regs))

    if not per_sm(1):
        raise ValueError(f"plan4: c {c}, {nh} heads: one staged window "
                         f"takes {attn4_smem(c, nh, 1, bwd)} bytes of shared "
                         f"memory, more than {BLOCK_SHARED_MAX}")
    stages = 1
    if windows > per_sm(1) * sms:
        stages = max((s for s in range(2, MAX_STAGES4 + 1) if per_sm(s)),
                     key=lambda s: (per_sm(s) * s, -s), default=1)
    grid = max(1, min(windows, per_sm(stages) * sms))
    plan = {"hdp": hdp, "ld": hdp + 8, "c": c, "heads": nh,
            "smem_bytes": attn4_smem(c, nh, stages, bwd),
            "threads": threads, "warps": warps, "tokens": 16,
            "windows": windows, "group": 1, "stages": stages, "grid": grid,
            "blocks": grid, "windows_per_block": -(-windows // grid),
            "blocks_per_sm": per_sm(stages), "max_registers": regs,
            "raw_pitch": raw_pitch(3 * c)}
    if bwd:
        plan.update(raw_pitch_dout=raw_pitch(c),
                    partial_bytes=grid * nh * 16 * 16 * 4)
    return plan


def plan4_at(plan: dict, stages: int, grid: int) -> dict:
    """The keys of a window-4 ``plan`` that change at another ring depth
    and grid (``scripts/torch_attention4_sweep.py`` times them)."""
    bwd = "partial_bytes" in plan
    out = {"stages": stages, "grid": grid, "blocks": grid,
           "smem_bytes": attn4_smem(plan["c"], plan["heads"], stages, bwd)}
    if bwd:
        out["partial_bytes"] = grid * plan["heads"] * 16 * 16 * 4
    return out


@functools.lru_cache(maxsize=None)
def window_attention_plan(c: int, nh: int, b: int = 1, h: int = 8,
                          w: int = 8, window: int = KERNEL_WINDOW,
                          sms: int = SMS) -> dict:
    """What kernel (c) launches for width ``c`` and ``nh`` heads at batch
    ``b``, ``h`` x ``w`` tokens and ``window`` x ``window`` windows. At
    window 8 one block of ``THREADS`` per (image, window, head), its shared
    memory the head's q/k/v planes [3][64][hdp + 8] bf16. At window 4
    :func:`plan4` on a card of ``sms`` SMs. At window 16 one
    block of ``WARPGROUPS16`` warpgroups per (image, window, head): the
    window's K and V (four 64-key tiles each) and one Q tile a warpgroup as
    swizzled tiles (:func:`swizzle_bytes`), the staging of one K and one V
    tile's 16-byte pieces (:func:`stage_bytes`; later each warpgroup's
    second Q tile), the head's relative-position table
    (``REL_TABLE_BYTES``), the window's region labels (``LABEL_BYTES``) and
    ``ALIGN_SLACK``; ``stats_bytes`` is the softmax statistics it writes
    when asked. Also the blocks an SM holds by shared memory (at window 16
    also by the source's ``__launch_bounds__``: two up to a head tile of 64,
    else one) and the registers a thread may use for that. The
    source refuses a launch whose shared memory differs from this plan's.
    Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention_plan: window {window}, the "
                         f"kernel takes {KERNEL_WINDOWS}")
    hdp = head_tile(c // nh)
    n = window * window
    windows = b * (h // window) * (w // window)
    if window == 4:
        return plan4(c, nh, b, h, w, sms)
    if window == KERNEL_WINDOW:
        smem = 3 * KEY_TILE * (hdp + 8) * 2
        threads = THREADS
        per_sm = SM_SHARED_BYTES // (smem + BLOCK_RESERVED)
        return {"hdp": hdp, "ld": hdp + 8, "smem_bytes": smem,
                "threads": threads, "tokens": n, "key_tiles": 1,
                "blocks": windows * nh, "blocks_per_sm": per_sm,
                "max_registers": min(255, REGISTERS // (threads * per_sm))}
    smem = (ALIGN_SLACK + 10 * swizzle_bytes(hdp) + 2 * stage_bytes(hdp)
            + REL_TABLE_BYTES + LABEL_BYTES)
    threads = 128 * WARPGROUPS16
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED),
                 2 if hdp <= 64 else 1)
    return {"hdp": hdp, "ld": hdp + 8, "tile_cols": swizzle_cols(hdp),
            "smem_bytes": smem, "threads": threads,
            "warpgroups": WARPGROUPS16, "tokens": n,
            "key_tiles": n // KEY_TILE, "blocks": windows * nh,
            "blocks_per_sm": per_sm,
            "max_registers": min(255, REGISTERS // (threads * per_sm)),
            "stats_bytes": windows * nh * n * 8}


def tc_min_blocks(n: int, hdp: int) -> int:
    """(c) f32's blocks an SM asked of the registers (the source's
    ``tc_min_blocks``, its ``__launch_bounds__``): 16 at N = 16 (128
    registers a thread), 3 at N >= 64 up to a head tile of 64, else 2."""
    return 16 if n == 16 else (3 if hdp <= 64 else 2)


@functools.lru_cache(maxsize=None)
def window_attention_f32_plan(c: int, nh: int, b: int = 1, h: int = 8,
                              w: int = 8, window: int = KERNEL_WINDOW
                              ) -> dict:
    """What the f32 kernel (``csrc/window_attention_tc_f32.cuh``) launches
    for width ``c`` and ``nh`` heads at batch ``b`` on ``h`` x ``w`` tokens:
    one block of ``threads`` (a warp per ``TC_WARP_ROWS`` query rows) per
    (image, window, head, query tile of ``rows`` = min(N, 64) rows), whose
    shared memory holds the q, k and v planes [rows][hdp + 4] f32 (the head
    dim padded to a multiple of 16, each row 4 floats more so that a
    fragment's eight rows start in eight different bank quads). The source
    refuses a launch whose shared memory differs from this plan's. Also the
    blocks an SM holds by shared memory, threads and the source's
    ``__launch_bounds__`` (``min_blocks``, and the registers a thread may
    use for it). Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention_f32_plan: window {window}, the "
                         f"kernel takes {KERNEL_WINDOWS}")
    hdp = head_tile(c // nh)
    n = window * window
    rows = min(n, KEY_TILE)
    pitch = hdp + 4
    threads = 32 * rows // TC_WARP_ROWS
    smem = 4 * 3 * rows * pitch
    tiles = n // rows
    least = tc_min_blocks(n, hdp)
    return {"hdp": hdp, "pitch": pitch, "tokens": n, "rows": rows,
            "key_tiles": tiles, "threads": threads, "smem_bytes": smem,
            "blocks": b * (h // window) * (w // window) * nh * tiles,
            "min_blocks": least,
            "max_registers": min(255, REGISTERS // (threads * least)),
            "blocks_per_sm": min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED),
                                 THREADS_PER_SM // threads, MAX_BLOCKS_PER_SM)}


def swizzle_cols(hdp: int) -> int:
    """Head dims a swizzled tile stores at N = 256: whole atoms of
    ``SWIZZLE_COLS``."""
    return -(-hdp // SWIZZLE_COLS) * SWIZZLE_COLS


def swizzle_bytes(hdp: int) -> int:
    """Bytes of one swizzled 64-row tile at N = 256 (``csrc/attn16.cuh``)."""
    return KEY_TILE * swizzle_cols(hdp) * 2


def stage_bytes(hdp: int) -> int:
    """Bytes of one part's staged tile at N = 256: 64 rows of at most
    ``hdp // 8 + 1`` 16-byte pieces (a head from any column offset)."""
    return KEY_TILE * (hdp // 8 + 1) * 16


def check_rows16(name: str, *tensors: torch.Tensor) -> None:
    """The layout rule of ``qkv`` and the context of kernel (c) and of the
    weights of kernel (g), on tensor metadata only (no card needed): 16-byte
    rows, that is unit column stride, a row stride that is a multiple of 16
    bytes (8 bf16, 4 f32) and a 16-byte aligned base."""
    for t in tensors:
        if t.stride(-1) != 1 or t.stride(0) * t.element_size() % 16 \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs 16-byte rows (unit column "
                             "stride, a row stride that is a multiple of "
                             "16 bytes and a 16-byte aligned base), got "
                             f"strides {tuple(t.stride())}")

def build_attn_term(bias: torch.Tensor, h: int, w: int, window: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[nW, nh, N, N] additive term: bias [nh, N, N] (+ mask [nW, N, N])."""
    nw = (h // window) * (w // window)
    term = bias[None].expand(nw, *bias.shape)
    if mask is not None:
        term = term + mask[:, None]
    return term


def window_scores(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 scores ``q k^T + bias (+ mask)`` [B*nW, nh, N, N] of pre-scaled
    ``q`` and ``k`` [B*nW, nh, N, hd], bias [nh, N, N], mask [nW, N, N]."""
    n, nh = q.shape[2], q.shape[1]
    s = q @ k.transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.view(-1, nw, nh, n, n)
             + mask.float()[None, :, None]).view(-1, nh, n, n)
    return s


def full_bias(bias: torch.Tensor, window: int) -> torch.Tensor:
    """The [nh, N, N] additive bias of ``bias`` given in either form: as it
    is, or its relative-position table [nh, (2W - 1)^2] gathered by the
    reference's ``relative_position_index`` (what ``relative_position_bias``
    does to a [(2W - 1)^2, nh] parameter)."""
    if bias.dim() == 3:
        return bias
    n = window * window
    idx = torch.as_tensor(relative_position_index(window).reshape(-1),
                          device=bias.device)
    return bias[:, idx].reshape(bias.shape[0], n, n)


def full_mask(mask: Optional[torch.Tensor],
              window: int) -> Optional[torch.Tensor]:
    """The [nW, N, N] additive shift mask of ``mask`` given in either form:
    as it is, or as each window's region labels [nW, N] (int32): 0 between
    tokens of one region, ``MASK_OFF`` between regions (what
    ``shift_attn_mask`` builds from ``shift_region_labels``)."""
    if mask is None or mask.dim() == 3:
        return mask
    off = torch.tensor(MASK_OFF, dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, :, None] != mask[:, None, :], off,
                       torch.zeros((), dtype=torch.float32,
                                   device=mask.device))


@functools.lru_cache(maxsize=None)
def shift_labels(h: int, w: int, window: int, shift: int,
                 device: torch.device) -> torch.Tensor:
    """[nW, N] int32 region labels of the shift mask on ``device``
    (``models/drct.py`` ``shift_region_labels``), built once per geometry
    at its first call (outside a CUDA graph's capture, which warms up
    first)."""
    return torch.as_tensor(shift_region_labels(h, w, window, shift),
                           device=device)


def attn_operands(p: dict, masks: dict, h: int, w: int, shift: int,
                  window: int) -> tuple:
    """(bias, mask) kernels (c) and (f) take for the Swin block dict ``p``
    (``kernels/fused_rdg.py`` ``pack_swin``) and the shift masks ``masks``
    ({shift: [nW, N, N] f32}, ``shift_masks``) on ``h`` x ``w`` tokens: at
    ``TILED_WINDOWS`` the relative-position table ``p["attn_table"]`` [nh,
    (2W - 1)^2] and the region labels [nW, N] int32
    (:func:`shift_labels`), else ``p["attn_bias"]`` [nh, N, N] and
    ``masks[shift]``; the mask None at shift 0."""
    mask = masks[shift] if shift else None
    if window not in TILED_WINDOWS:
        return p["attn_bias"], mask
    return p["attn_table"], (None if mask is None else shift_labels(
        h, w, window, shift, mask.device))


def check_mask(name: str, mask: Optional[torch.Tensor], nw: int,
               window: int, card: bool) -> None:
    """``mask`` is None, [nW, N, N] f32 or region labels [nW, N] int32; on
    the card the labels at ``TILED_WINDOWS`` and the full mask at other
    windows (what the kernels read)."""
    if mask is None:
        return
    n = window * window
    if not ((mask.shape == (nw, n, n) and mask.dtype == torch.float32)
            or (mask.shape == (nw, n) and mask.dtype == torch.int32)):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} {mask.dtype}, "
                         f"expected {(nw, n, n)} f32 or labels {(nw, n)} "
                         "int32")
    if card and (mask.dim() == 2) != (window in TILED_WINDOWS):
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes the shift mask as region labels "
            f"[nW, N] int32 at windows {TILED_WINDOWS} and as [nW, N, N] at "
            f"other windows (got {tuple(mask.shape)} at window {window})")


def check_bias(name: str, bias: torch.Tensor, nh: int, window: int,
               card: bool) -> None:
    """``bias`` is [nh, N, N] or a relative-position table [nh, (2W -
    1)^2]; on the card the table at ``TILED_WINDOWS`` and the full bias at
    other windows (what the kernels read)."""
    n, t = window * window, (2 * window - 1) ** 2
    if bias.shape not in ((nh, n, n), (nh, t)):
        raise ValueError(f"{name}: bias {tuple(bias.shape)}, expected "
                         f"{(nh, n, n)} or a table {(nh, t)}")
    if card and (bias.dim() == 2) != (window in TILED_WINDOWS):
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes the bias as its relative-position "
            f"table [nh, (2W - 1)^2] at windows {TILED_WINDOWS} and as [nh, "
            f"N, N] at other windows (got {tuple(bias.shape)} at window "
            f"{window})")


def softmax_stats(qkv: torch.Tensor, h: int, w: int, num_heads: int,
                  window: int) -> Optional[torch.Tensor]:
    """An empty f32 buffer [B*nW, nh, N, 2] for each query row's softmax
    statistics (max, 1 / sum) per head, which kernel (c) writes at windows
    ``TILED_WINDOWS`` and kernel (f) reads there; None at other windows."""
    if window not in TILED_WINDOWS:
        return None
    n = window * window
    windows = qkv.shape[0] // (h * w) * (h // window) * (w // window)
    return torch.empty(windows, num_heads, n, 2, dtype=torch.float32,
                       device=qkv.device)


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], h: int, w: int,
                           num_heads: int, window: int, shift: int,
                           stats: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """f32 context [B*L, c] from raster-order qkv [B*L, 3c]; ``bias`` and
    ``mask`` in either form (:func:`full_bias`, :func:`full_mask`); with
    ``stats`` [B*nW, nh, N, 2] also
    each query row's (max, 1 / sum of exp(score - max)) of its f32
    scores."""
    bias, mask = full_bias(bias, window), full_mask(mask, window)
    m, c3 = qkv.shape
    c = c3 // 3
    b = m // (h * w)
    nh, hd, n = num_heads, c // num_heads, window * window
    x = qkv.float().reshape(b, h, w, c3)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = window_partition(x, window).reshape(-1, n, 3, nh, hd)
    q, k, v = xw.permute(2, 0, 3, 1, 4)                  # [B*nW, nh, N, hd]
    o = window_attention_eager(q * hd ** -0.5, k, v, bias.float(),
                               None if mask is None else mask.float())
    if stats is not None:
        s = window_scores(q * hd ** -0.5, k, bias, mask)
        mx = s.amax(-1)
        stats.copy_(torch.stack(
            (mx, 1.0 / torch.exp(s - mx[..., None]).sum(-1)), -1))
    o = window_reverse(o.transpose(1, 2).reshape(-1, n, c), window, h, w)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o.reshape(m, c)


def window_attention(qkv: torch.Tensor, out: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], h: int, w: int,
                     num_heads: int, window: int, shift: int,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Context of raster-order ``qkv`` [B*h*w, 3c] into ``out`` [B*h*w, c],
    both with 16-byte rows on the card (any strides on the CPU).

    ``bias`` f32 [nh, N, N] or its relative-position table [nh, (2W -
    1)^2] (on the card: the table at ``TILED_WINDOWS``, :func:`check_bias`);
    ``mask`` when ``shift > 0``: [nW, N, N] f32 or its region labels [nW,
    N] int32 (on the card: the labels at ``TILED_WINDOWS``,
    :func:`check_mask`); ``stats`` (or None) f32
    [B*nW, nh, N, 2] (:func:`softmax_stats`) receives each query row's
    (max, 1 / sum), at windows ``TILED_WINDOWS`` on the card."""
    m, c3 = qkv.shape
    c = c3 // 3
    n = window * window
    nw = (h // window) * (w // window)
    check_bias("window_attention", bias, num_heads, window, card=False)
    check_mask("window_attention", mask, nw, window, card=False)
    if (c3 % 3 or m % (h * w) or out.shape != (m, c) or c % num_heads
            or (shift > 0) != (mask is not None)
            or (stats is not None and stats.shape
                != (m // (h * w) * nw, num_heads, n, 2))):
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)}, out "
                         f"{tuple(out.shape)}, bias {tuple(bias.shape)}, "
                         f"heads {num_heads}, shift {shift}, mask "
                         f"{None if mask is None else tuple(mask.shape)}, "
                         f"stats {None if stats is None else tuple(stats.shape)}")
    if qkv.device.type == "cpu":
        out.copy_(window_attention_plain(qkv, bias, mask, h, w, num_heads,
                                         window, shift, stats))
        return out
    if window not in KERNEL_WINDOWS or h % window or w % window \
            or c // num_heads > 128 or c % 4:
        raise NotImplementedError(
            f"window_attention: the CUDA kernel takes {windows_text()}, "
            f"widths that are multiples of 4 and head dims <= 128 (got "
            f"window {window}, {h}x{w}, c {c}, hd {c // num_heads})")
    f32 = _build.require_cuda("window_attention", _build.BF16_F32, qkv,
                              out) == torch.float32
    check_rows16("window_attention", qkv, out)
    check_bias("window_attention", bias, num_heads, window, card=True)
    check_mask("window_attention", mask, nw, window, card=True)
    params = (bias,) + ((mask,) if mask is not None and mask.dim() == 3
                        else ()) + ((stats,) if stats is not None else ())
    _build.require_f32_cuda("window_attention", *params)
    if mask is not None and (mask.device != qkv.device
                             or not mask.is_contiguous()):
        raise ValueError("window_attention: mask must be contiguous on the "
                         "card")
    b = m // (h * w)
    plan = window_attention_plan(c, num_heads, b, h, w, window,
                                 _build.sm_count(qkv.device)) \
        if window == 4 else window_attention_plan(c, num_heads, window=window)
    args = (qkv.data_ptr(), qkv.stride(0), out.data_ptr(), out.stride(0),
            bias.data_ptr(), None if mask is None else mask.data_ptr())
    if window not in TILED_WINDOWS and stats is not None:
        raise ValueError(f"window_attention: the kernel writes softmax "
                         f"statistics at windows {TILED_WINDOWS} only")
    if f32:
        plan = window_attention_f32_plan(c, num_heads, b, h, w, window)
        entry = getattr(_build.library(), F32_ENTRIES[window])
        if window in TILED_WINDOWS:     # (max, 1 / sum) a query row
            args += (None if stats is None else stats.data_ptr(),)
        rc = entry(*args, b, h, w, c, num_heads, window, shift,
                   plan["smem_bytes"], _build.stream_ptr(qkv))
        _build.check_rc("window_attention", rc)
        window_attention.launches_f32 += 1
        return out
    if window == KERNEL_WINDOW:
        rc = _build.library().adsr_window_attention(
            *args, b, h, w, c, num_heads, window, shift,
            plan["smem_bytes"], _build.stream_ptr(qkv))
    elif window == 4:
        rc = _build.library().adsr_window_attention4(
            *args, b, h, w, c, num_heads, shift, plan["stages"],
            plan["grid"], plan["smem_bytes"], _build.stream_ptr(qkv))
    else:
        rc = _build.library().adsr_window_attention16(
            *args, None if stats is None else stats.data_ptr(),
            b, h, w, c, num_heads, shift, plan["smem_bytes"],
            _build.stream_ptr(qkv))
    _build.check_rc("window_attention", rc)
    window_attention.launches += 1
    return out


window_attention.launches = 0
window_attention.launches_f32 = 0
