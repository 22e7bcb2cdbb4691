"""Kernel (f) ``window_attention_bwd``: backward of the shifted-window MSA.

From the raster-order ``qkv`` [B*L, 3c] and the context's gradient ``dout``
[B*L, c]: recompute ``S = q k^T * scale + bias + mask`` and the stabilised
softmax ``P``, then ``dV = P^T dO``, ``dP = dO V^T``,
``dS = P o (dP - rowsum(dO o O))``, ``dQ = dS K * scale``,
``dK = dS^T Q * scale``, written into a raster-order ``dqkv`` [B*L, 3c], and
``d(bias)`` [nh, N, N], the sum of dS over every window of every image
(deterministic two-pass reduction).

Replaces the attention backward phases of the Pallas kernel ``_bwd_kernel``
(``adsr_tpu/ops/fused_rdg_train.py:405-770``). Source:
``adsr_tpu_torch/csrc/window_attention_bwd.cu`` on the backward core of
``csrc/window_attn_bwd_core.cuh``. Bound on the H100: bytes. Design: a
block takes one head and a group of consecutive windows
(:func:`window_attention_bwd_plan`), gathers each window's q, k, v and dO by
16-byte pieces, keeps S, P, dP, dS and dQ of each warp's 16 rows in
registers, computes dK and dV from bf16 P and dS tiles, and writes one
d(bias) partial per (group, head). At 16x16 windows (N = 256, the
256px and 512/x8 models; ``csrc/window_attention_bwd16.cu`` on
``csrc/attn16.cuh``) FlashAttention-2's deterministic backward in two
launches on tiles of 64 tokens, every product on ``wgmma``
(:func:`_plan16`). It also takes the forward's context ``ctx`` and each
query row's softmax statistics ``stats`` (max, 1 / sum), which kernel (c)
writes in the training backward's recompute
(:func:`~adsr_tpu_torch.kernels.window_attention.softmax_stats`): a ``dq``
launch per (window, head, query tile) sweeps the key tiles once (P from
the statistics, ``D = rowsum(dO o O)`` from ``dout`` and ``ctx``) and
writes each row's (max, 1 / sum, D), then a ``dkv`` launch of two
warpgroups per (group of windows, head, key tile) accumulates dK, dV and
an f32 d(bias) tile of its keys in shared memory, one [nh, 256, 256]
partial per group (at most 32 MiB a call); both count in ``launches``. At
4x4 windows (N = 16, the 64/x4, 128/x8 and 32/x2 models;
``csrc/window_attention_bwd4.cu`` on ``csrc/attn4.cuh``) the forward's map
(:func:`~adsr_tpu_torch.kernels.window_attention.plan4`): a block takes
every head of its windows and stages whole token rows of qkv and dO, a
head's warp (two for four heads or fewer) holds a whole window, so its
dQ, dK and dV need no cross-warp sum, whole rows of dqkv go back in
16-byte stores, and each block writes
one d(bias) partial [nh, 16, 16], summed by ``partials.cuh``'s column
pass. No float atomics at any window. The kernel takes the
forward's windows (``KERNEL_WINDOWS``), and ``qkv``, ``dout``, ``ctx`` and
``dqkv`` with 16-byte rows at their row strides (:func:`check_rows16`).

f32 operands (fp32 training: the TPU kernel at dtype f32) go to a kernel
of their own, ``csrc/window_attention_bwd_f32.cuh`` (one source a window:
``window_attention_bwd4_f32.cu``, ``window_attention_bwd_f32.cu``,
``window_attention_bwd16_f32.cu``, whose head tiles past 64 build from
``window_attention_bwd16_f32_wide.cu``), a block's head staged from the 16-byte
pieces that hold it into f32 planes, every product f32-accurate as 3xTF32
on the tensor cores (``mma.sync`` m16n8k8, each operand split into TF32 hi
and lo parts); at N = 16 and 64 one launch, a block of eight warps per
(group of windows, head) recomputing the softmax 64 token rows at a time
(the next rows landing by ``cp.async`` while one set is computed, whole
16-byte pieces stored); at N = 256 the forward's context and statistics
(kernel (c) f32's) and two launches, ``dq`` per (window, head, query tile)
and ``dkv`` per (group of windows, head, key tile) with its keys' d(bias)
columns in shared memory (:func:`window_attention_bwd_f32_plan`); one
d(bias) partial a (group, head), summed in a fixed order. Bound on the
H100: bytes at N = 16 and 64, operations at N = 256. Its launches count in
``window_attention_bwd.launches_f32`` (two a call at N = 256), the bf16
ones in ``launches``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
the call raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.window_attention import (
    ALIGN_SLACK, BLOCK_RESERVED, BLOCK_SHARED_MAX, F32_THREADS, KEY_TILE,
    KERNEL_WINDOW, KERNEL_WINDOWS, LABEL_BYTES, REGISTERS, REL_TABLE_BYTES,
    SM_SHARED_BYTES, SMS, THREADS_PER_SM, TILED_WINDOWS, check_bias,
    check_mask, check_rows16, full_bias, full_mask, head_tile, plan4,
    stage_bytes, swizzle_bytes, window_scores, windows_text)
from adsr_tpu_torch.models.drct import window_partition, window_reverse

THREADS = 128          # 4 warps, 16 query (and key) rows each
MAX_GROUP = 8          # windows a block
_TOKENS = KERNEL_WINDOW ** 2
_TILE_LD = _TOKENS + 8          # bf16 pitch of the P and dS tiles
MAX_PARTIAL_BYTES = 32 << 20    # d(bias) partials a call at 16x16 windows
# the f32 kernel's C entry a window (a source a window, built in parallel)
F32_ENTRIES = {8: "adsr_window_attention_bwd_f32",
               4: "adsr_window_attention_bwd4_f32",
               16: "adsr_window_attention_bwd16_f32"}


def min_blocks(hdp: int) -> int:
    """Blocks an SM holds by registers: the source's ``__launch_bounds__``
    minimum (168 registers a thread up to a head tile of 80, else 255)."""
    return 3 if hdp <= 80 else 2


@functools.lru_cache(maxsize=None)
def window_attention_bwd_plan(c: int, nh: int, b: int = 1, h: int = 8,
                              w: int = 8, sms: int = SMS,
                              window: int = KERNEL_WINDOW) -> dict:
    """What kernel (f) launches for width ``c`` and ``nh`` heads at batch
    ``b`` and ``h`` x ``w`` tokens. A block of ``THREADS`` takes one head
    and ``group`` consecutive (image, window)s, the last group possibly
    short; its shared memory holds the head's q, k, v and dO planes
    [4][64][hdp + 8] and the bf16 P and dS tiles [2][64][72]. ``group`` is
    the fewest windows a block (at most ``MAX_GROUP``) for which every
    block is resident at once, ``blocks_per_sm`` of them an SM (by shared
    memory and :func:`min_blocks`): one wave, as many blocks as fit, and
    G times fewer d(bias) partials, one per (group, head), than windows.
    The source refuses a launch whose shared memory differs from this
    plan's. Read only (cached). ``window`` 4:
    :func:`~adsr_tpu_torch.kernels.window_attention.plan4`; 16:
    :func:`_plan16`."""
    if window == 4:
        return plan4(c, nh, b, h, w, sms, bwd=True)
    if window != KERNEL_WINDOW:
        return _plan16(c, nh, b, h, w, window)
    hdp = head_tile(c // nh)
    smem = 4 * _TOKENS * (hdp + 8) * 2 + 2 * _TOKENS * _TILE_LD * 2
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED), min_blocks(hdp))
    windows = b * (h // KERNEL_WINDOW) * (w // KERNEL_WINDOW)
    group = next((g for g in range(1, MAX_GROUP)
                  if nh * -(-windows // g) <= per_sm * sms), MAX_GROUP)
    groups = -(-windows // group)
    return {"hdp": hdp, "ld": hdp + 8, "smem_bytes": smem,
            "threads": THREADS, "windows": windows, "group": group,
            "groups": groups, "last_group": windows - (groups - 1) * group,
            "blocks": groups * nh, "blocks_per_sm": per_sm,
            "max_registers": min(255, REGISTERS // (THREADS * per_sm)),
            "partial_bytes": groups * nh * _TOKENS * _TOKENS * 4}


def _plan16(c: int, nh: int, b: int, h: int, w: int, window: int) -> dict:
    """Kernel (f) at 16x16 windows (N = 256): two launches and the partial
    sums, every tile a swizzled 64-row tile
    (:func:`~adsr_tpu_torch.kernels.window_attention.swizzle_bytes`).
    ``dq``: one warpgroup per (image, window, head, tile of 64 query rows),
    shared memory ``smem_dq_bytes`` (``ALIGN_SLACK``, its Q, dO, K and V
    tiles, the staging of the next K and V tiles, D of its 64 rows, the
    head's relative-position table and the window's region labels); it
    writes each row's (max, 1 / sum, D), ``stats_bytes``. ``dkv``: two
    warpgroups per (group of ``group`` windows, head, tile of 64 keys),
    shared memory ``smem_bytes`` (``ALIGN_SLACK``, the K and V tiles, each
    warpgroup's Q and dO tiles and their rows' statistics, an f32 d(bias)
    tile [256][64], the head's table, the window's labels and, where they
    fit, each warpgroup's staging of its next Q and dO tiles and their
    statistics (``dkv_staged``), then the staging of the next window's K
    and V tiles (``dkv_kv_staged``)); each writes its columns of one
    [nh][256][256] f32 partial per group. ``group`` is the fewest windows a
    block that keep the partials within ``MAX_PARTIAL_BYTES``. The blocks an
    SM holds by shared memory and by the sources' ``__launch_bounds__``
    (dkv one; dq three up to a head tile of 64, else two)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention_bwd_plan: window {window}, the "
                         f"kernel takes {KERNEL_WINDOWS}")
    hdp = head_tile(c // nh)
    n = window * window
    tiles = n // KEY_TILE
    tile = swizzle_bytes(hdp)
    smem_dq = (ALIGN_SLACK + 4 * tile + 2 * stage_bytes(hdp) + KEY_TILE * 4
               + REL_TABLE_BYTES + LABEL_BYTES)
    smem = (ALIGN_SLACK + 6 * tile + 2 * KEY_TILE * 16 + n * KEY_TILE * 4
            + REL_TABLE_BYTES + LABEL_BYTES)
    qg_stage = 2 * stage_bytes(hdp) + KEY_TILE * 16
    staged = smem + 2 * qg_stage <= BLOCK_SHARED_MAX
    smem += 2 * qg_stage if staged else 0
    kv_staged = staged and smem + 2 * stage_bytes(hdp) <= BLOCK_SHARED_MAX
    smem += 2 * stage_bytes(hdp) if kv_staged else 0
    windows = b * (h // window) * (w // window)
    per_group = nh * n * n * 4
    group = max(1, -(-windows // max(1, MAX_PARTIAL_BYTES // per_group)))
    groups = -(-windows // group)
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED), 1)
    dq_per_sm = min(SM_SHARED_BYTES // (smem_dq + BLOCK_RESERVED),
                    3 if hdp <= 64 else 2)
    return {"hdp": hdp, "ld": hdp + 8, "smem_bytes": smem,
            "smem_dq_bytes": smem_dq, "dkv_staged": staged,
            "dkv_kv_staged": kv_staged,
            "threads": 2 * THREADS, "dq_threads": THREADS, "tokens": n,
            "key_tiles": tiles, "windows": windows, "group": group,
            "groups": groups, "last_group": windows - (groups - 1) * group,
            "blocks": groups * nh * tiles,
            "dq_blocks": windows * nh * tiles,
            "blocks_per_sm": per_sm, "dq_blocks_per_sm": dq_per_sm,
            "max_registers": min(255, REGISTERS // (2 * THREADS * per_sm)),
            "partial_bytes": groups * per_group,
            "stats_bytes": windows * nh * n * 16, "launches": 2}


# floats a row of the f32 dkv launch's d(bias) tile at N = 256: two rows
# apart by 8 banks, so a warp's paired-row updates are free of conflicts
DB_PITCH = KEY_TILE + 4
# the f32 N = 256 launches' exchange of C fragments between the two warps
# of a row: [writer][4 row warps][4 n8 tiles][32 lanes] float4s
EXCHANGE_BYTES = 2 * 4 * 4 * 32 * 16


# each row's (max, 1 / sum) and D in the f32 N = 256 launches
STAT_BYTES = 3 * KEY_TILE * 4


def bwd16_f32_min_blocks(hdp: int) -> Tuple[int, int]:
    """(dq, dkv): the blocks an SM the f32 N = 256 sources'
    ``__launch_bounds__`` ask registers for (``Tc16``): dq two at head
    tiles 32 to 64 (where 128 registers hold a thread without spills),
    else one; dkv one."""
    return (2 if 32 <= hdp <= 64 else 1), 1


def bwd16_f32_dkv_buffers(hdp: int) -> int:
    """The q and dO buffers of the f32 dkv launch at N = 256 (``Tc16``'s
    ``kDkvBuffers``): two where six planes, the exchange, two sets of row
    statistics and the d(bias) tile fit a block's shared memory, else
    one."""
    plane = KEY_TILE * (hdp + 4) * 4
    two = 6 * plane + EXCHANGE_BYTES + 2 * STAT_BYTES \
        + 256 * DB_PITCH * 4
    return 2 if two <= BLOCK_SHARED_MAX else 1


def bwd_f32_min_blocks(hdp: int) -> int:
    """The blocks an SM the f32 N = 16 / 64 source's ``__launch_bounds__``
    asks registers for (``Tc64::kMinBlocks``): two (128 registers a thread)
    up to a head tile of 48, else one."""
    return 2 if hdp <= 48 else 1


def bwd_f32_buffers(n: int, hdp: int) -> int:
    """Sets of the four planes of the f32 N = 16 / 64 kernel
    (``Tc64::kBuffers``): two where eight planes [64][hdp + 4], the P and
    dS tiles [64][N + 4] and the rows' halves of max, sum and D fit a
    block's shared memory (the next set's rows land while one is
    computed), else one."""
    plane = KEY_TILE * (hdp + 4) * 4
    rest = 2 * KEY_TILE * (n + 4) * 4 + 3 * 2 * KEY_TILE * 4
    return 2 if 8 * plane + rest <= BLOCK_SHARED_MAX else 1


@functools.lru_cache(maxsize=None)
def window_attention_bwd_f32_plan(c: int, nh: int, b: int = 1, h: int = 8,
                                  w: int = 8, window: int = KERNEL_WINDOW,
                                  sms: int = SMS) -> dict:
    """What the f32 kernel (``csrc/window_attention_bwd_f32.cuh``) launches
    for width ``c`` and ``nh`` heads at batch ``b`` on ``h`` x ``w`` tokens,
    every product 3xTF32 on the tensor cores. Blocks of ``F32_THREADS``
    (eight warps); q, k, v and dO planes [64][hdp + 4] f32. At N = 16 and 64
    (``hdp`` the head dim rounded up to 16) one launch, a block per (group
    of ``group`` windows, head) walking its group 64 token rows at a time
    (``set_windows``: one 8x8 window or four 4x4 windows), with
    ``buffers`` sets of the four planes (:func:`bwd_f32_buffers`: two
    where they fit, the next set landing while one is computed), the P and
    dS tiles [64][N + 4] (``tile_pitch``) and the rows' halves of max, sum
    and D: ``group`` is the fewest windows, a multiple of ``set_windows``,
    for which every block is resident at once (``blocks_per_sm`` by shared
    memory and :func:`bwd_f32_min_blocks`), at most ``MAX_GROUP`` sets. At
    N = 256 (``hdp`` rounded up to 8: the tensor cores' k8 steps and n8
    tiles) two: ``dq`` a block per (window, head, query tile), shared
    memory ``smem_dq_bytes`` (q, dO and two k and v planes: the next key
    tile lands while one is computed; the warps' exchange
    ``EXCHANGE_BYTES`` and its rows' max, 1 / sum and D, ``STAT_BYTES``),
    and ``dkv`` a block per (group, head, key tile), ``smem_bytes`` (k and
    v, ``dkv_buffers`` q and dO planes with their rows' statistics (:func:`
    bwd16_f32_dkv_buffers`), the exchange and the d(bias) tile
    [256][``DB_PITCH``] of its keys), ``group`` the fewest windows that keep
    the partials within ``MAX_PARTIAL_BYTES``; their blocks an SM by shared
    memory and the sources' ``__launch_bounds__`` (:func:`
    bwd16_f32_min_blocks`); ``dsum_bytes`` the scratch of each query row's
    D. One d(bias) partial [nh, N, N] a group (``partial_bytes``). The
    source refuses a launch whose shared memory differs from this plan's.
    Read only (cached)."""
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention_bwd_f32_plan: window {window}, "
                         f"the kernel takes {KERNEL_WINDOWS}")
    n = window * window
    hd = c // nh
    hdp = -(-hd // 8) * 8 if n > KEY_TILE else head_tile(hd)
    rows = KEY_TILE
    windows = b * (h // window) * (w // window)

    def per_sm(smem, most):
        return min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED),
                   THREADS_PER_SM // F32_THREADS, most)

    plan = {"hdp": hdp, "pitch": hdp + 4, "tokens": n, "rows": rows,
            "threads": F32_THREADS, "windows": windows}
    if n <= KEY_TILE:
        plane = rows * (hdp + 4) * 4
        buffers = bwd_f32_buffers(n, hdp)
        smem = 4 * buffers * plane + 2 * rows * (n + 4) * 4 \
            + 3 * 2 * rows * 4
        fit = per_sm(smem, bwd_f32_min_blocks(hdp))
        wps = rows // n
        group = next((g for g in range(wps, MAX_GROUP * wps, wps)
                      if nh * -(-windows // g) <= fit * sms),
                     MAX_GROUP * wps)
        groups = -(-windows // group)
        plan.update(smem_bytes=smem, blocks_per_sm=fit, launches=1,
                    blocks=groups * nh, buffers=buffers, set_windows=wps,
                    tile_pitch=n + 4,
                    min_blocks=bwd_f32_min_blocks(hdp))
    else:
        plane = rows * (hdp + 4) * 4
        buffers = bwd16_f32_dkv_buffers(hdp)
        smem_dq = 6 * plane + EXCHANGE_BYTES + STAT_BYTES
        smem = (2 + 2 * buffers) * plane + EXCHANGE_BYTES \
            + buffers * STAT_BYTES + n * DB_PITCH * 4
        dq_most, dkv_most = bwd16_f32_min_blocks(hdp)
        per_group = nh * n * n * 4
        group = max(1, -(-windows // max(1, MAX_PARTIAL_BYTES // per_group)))
        groups = -(-windows // group)
        tiles = n // rows
        plan.update(smem_bytes=smem, smem_dq_bytes=smem_dq,
                    blocks_per_sm=per_sm(smem, dkv_most),
                    dq_blocks_per_sm=per_sm(smem_dq, dq_most),
                    dkv_buffers=buffers, launches=2,
                    blocks=groups * nh * tiles,
                    dq_blocks=windows * nh * tiles,
                    dsum_bytes=windows * nh * n * 4)
    plan.update(group=group, groups=groups,
                last_group=windows - (groups - 1) * group,
                partial_bytes=groups * nh * n * n * 4)
    return plan


def window_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor], h: int, w: int,
                               num_heads: int, window: int, shift: int,
                               ctx: Optional[torch.Tensor] = None,
                               stats: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (dqkv [B*L, 3c], dbias [nh, N, N]); any strides; ``bias`` and
    ``mask`` in either form (``kernels/window_attention.py`` ``full_bias``,
    ``full_mask``). With the forward's context ``ctx`` [B*L, c] and softmax
    statistics ``stats`` [B*nW, nh, N, 2] (max, 1 / sum), as the kernel at
    16x16 windows takes them: P = exp(S - max) / sum and D = rowsum(dO o
    O); without, the softmax of S and D = rowsum(P o dP)."""
    m, c3 = qkv.shape
    c = c3 // 3
    b = m // (h * w)
    nh, hd, n = num_heads, c // num_heads, window * window

    def windows(t: torch.Tensor) -> torch.Tensor:
        x = t.float().reshape(b, h, w, t.shape[1])
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        return window_partition(x, window)                # [B*nW, N, ch]

    q, k, v = windows(qkv).reshape(-1, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    do = windows(dout).reshape(-1, n, nh, hd).transpose(1, 2)
    scale = hd ** -0.5
    s = window_scores(q * scale, k, full_bias(bias, window),
                      full_mask(mask, window))
    dp = do @ v.transpose(-1, -2)
    if stats is None:
        p = s.softmax(dim=-1)
        d = (dp * p).sum(-1, keepdim=True)
    else:
        st = stats.float()
        p = torch.exp(s - st[..., :1]) * st[..., 1:]
        o = windows(ctx).reshape(-1, n, nh, hd).transpose(1, 2)
        d = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dq = ds @ k * scale
    dk = ds.transpose(-1, -2) @ q * scale
    dv = p.transpose(-1, -2) @ do
    g = torch.stack([dq, dk, dv], 2)                      # [B*nW, nh, 3, N, hd]
    g = g.permute(0, 3, 2, 1, 4).reshape(-1, n, c3)
    g = window_reverse(g, window, h, w)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2))
    return g.reshape(m, c3), ds.sum(0)


def window_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         h: int, w: int, num_heads: int, window: int,
                         shift: int, dqkv: torch.Tensor,
                         dbias: torch.Tensor,
                         ctx: Optional[torch.Tensor] = None,
                         stats: Optional[torch.Tensor] = None) -> None:
    """Write the gradient of ``qkv`` into ``dqkv`` [B*L, 3c] and of the
    additive bias into ``dbias`` [nh, N, N] (f32). ``bias`` is [nh, N, N]
    or its relative-position table [nh, (2W - 1)^2], ``mask`` [nW, N, N]
    or its region labels [nW, N], as kernel (c) takes them (on the card the
    compact forms at ``TILED_WINDOWS``). ``ctx`` [B*L, c] and
    ``stats`` [B*nW, nh, N, 2] f32 are the forward's context and softmax
    statistics (kernel (c) with ``stats``): the card needs them at windows
    ``TILED_WINDOWS``, the plain version uses them where given. On the card
    ``qkv``, ``dout``, ``ctx`` and ``dqkv`` have 16-byte rows (any row
    stride that is a multiple of 8); any strides on the CPU."""
    m, c3 = qkv.shape
    c = c3 // 3
    n = window * window
    nw = (h // window) * (w // window)
    check_bias("window_attention_bwd", bias, num_heads, window, card=False)
    check_mask("window_attention_bwd", mask, nw, window, card=False)
    if (c3 % 3 or m % (h * w) or dout.shape != (m, c) or c % num_heads
            or dqkv.shape != (m, c3) or dbias.shape != (num_heads, n, n)
            or (shift > 0) != (mask is not None)
            or (ctx is None) != (stats is None)
            or (ctx is not None and ctx.shape != (m, c))
            or (stats is not None and stats.shape
                != (m // (h * w) * nw, num_heads, n, 2))):
        raise ValueError(f"window_attention_bwd: qkv {tuple(qkv.shape)}, "
                         f"dout {tuple(dout.shape)}, dqkv "
                         f"{tuple(dqkv.shape)}, heads {num_heads}, shift "
                         f"{shift}, ctx and stats given together")
    if qkv.device.type == "cpu":
        gq, gb = window_attention_bwd_plain(qkv, dout, bias, mask, h, w,
                                            num_heads, window, shift, ctx,
                                            stats)
        dqkv.copy_(gq)
        dbias.copy_(gb)
        return
    if window not in KERNEL_WINDOWS or h % window or w % window \
            or c // num_heads > 128 or c % 4:
        raise NotImplementedError(
            f"window_attention_bwd: the CUDA kernel takes {windows_text()}, "
            f"widths that are multiples of 4 and head dims <= 128 (got "
            f"window {window}, c {c}, hd {c // num_heads})")
    check_rows16("window_attention_bwd", qkv, dout, dqkv)
    f32 = _build.require_cuda("window_attention_bwd", _build.BF16_F32, qkv,
                              dout, dqkv) == torch.float32
    check_bias("window_attention_bwd", bias, num_heads, window, card=True)
    check_mask("window_attention_bwd", mask, nw, window, card=True)
    params = (bias, dbias) + ((mask,) if mask is not None
                              and mask.dim() == 3 else ())
    _build.require_f32_cuda("window_attention_bwd", *params)
    if mask is not None and (mask.device != qkv.device
                             or not mask.is_contiguous()):
        raise ValueError("window_attention_bwd: mask must be contiguous on "
                         "the card")
    if (window in TILED_WINDOWS) != (stats is not None):
        raise ValueError(f"window_attention_bwd: the kernel takes the "
                         f"forward's ctx and softmax statistics at windows "
                         f"{TILED_WINDOWS}, and only there (window "
                         f"{window})")
    b = m // (h * w)
    if window in TILED_WINDOWS:
        _build.require_cuda("window_attention_bwd", _build.BF16_F32, qkv,
                            ctx)
        check_rows16("window_attention_bwd", ctx)
        _build.require_f32_cuda("window_attention_bwd", stats)
    if f32:
        _launch_f32(qkv, dout, bias, mask, h, w, num_heads, window, shift,
                    dqkv, dbias, ctx, stats)
        return
    plan = window_attention_bwd_plan(c, num_heads, b, h, w,
                                     _build.sm_count(qkv.device), window)
    part = torch.empty(plan["partial_bytes"] // 4, dtype=torch.float32,
                       device=qkv.device)
    lib = _build.library()
    if window == 4:
        rc = lib.adsr_window_attention_bwd4(
            qkv.data_ptr(), qkv.stride(0), dout.data_ptr(), dout.stride(0),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            dqkv.data_ptr(), dqkv.stride(0), part.data_ptr(),
            dbias.data_ptr(), b, h, w, c, num_heads, shift, plan["stages"],
            plan["grid"], plan["smem_bytes"], _build.stream_ptr(qkv))
    elif window == KERNEL_WINDOW:
        rc = lib.adsr_window_attention_bwd(
            qkv.data_ptr(), qkv.stride(0), dout.data_ptr(), dout.stride(0),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            dqkv.data_ptr(), dqkv.stride(0), part.data_ptr(),
            dbias.data_ptr(), b, h, w, c, num_heads, window, shift,
            plan["group"], plan["smem_bytes"], _build.stream_ptr(qkv))
    else:
        stats4 = torch.empty(plan["stats_bytes"] // 4, dtype=torch.float32,
                             device=qkv.device)
        rc = lib.adsr_window_attention_bwd16(
            qkv.data_ptr(), qkv.stride(0), dout.data_ptr(), dout.stride(0),
            ctx.data_ptr(), ctx.stride(0), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), stats.data_ptr(),
            dqkv.data_ptr(), dqkv.stride(0), stats4.data_ptr(),
            part.data_ptr(), dbias.data_ptr(), b, h, w, c, num_heads, shift,
            plan["group"], plan["smem_dq_bytes"], plan["smem_bytes"],
            _build.stream_ptr(qkv))
    _build.check_rc("window_attention_bwd", rc)
    # one for each of (f)'s own kernels (the partial sums not counted)
    window_attention_bwd.launches += plan.get("launches", 1)


def _launch_f32(qkv, dout, bias, mask, h, w, num_heads, window, shift, dqkv,
                dbias, ctx, stats) -> None:
    """The f32 kernel's launch (one C entry a window), counted in
    ``launches_f32``."""
    m, c3 = qkv.shape
    c, b = c3 // 3, m // (h * w)
    plan = window_attention_bwd_f32_plan(c, num_heads, b, h, w, window,
                                         _build.sm_count(qkv.device))
    part = torch.empty(plan["partial_bytes"] // 4, dtype=torch.float32,
                       device=qkv.device)
    entry = getattr(_build.library(), F32_ENTRIES[window])
    mask_ptr = None if mask is None else mask.data_ptr()
    if window in TILED_WINDOWS:
        dsum = torch.empty(plan["dsum_bytes"] // 4, dtype=torch.float32,
                           device=qkv.device)
        rc = entry(qkv.data_ptr(), qkv.stride(0), dout.data_ptr(),
                   dout.stride(0), ctx.data_ptr(), ctx.stride(0),
                   bias.data_ptr(), mask_ptr, stats.data_ptr(),
                   dqkv.data_ptr(), dqkv.stride(0), dsum.data_ptr(),
                   part.data_ptr(), dbias.data_ptr(), b, h, w, c, num_heads,
                   shift, plan["group"], plan["smem_dq_bytes"],
                   plan["smem_bytes"], _build.stream_ptr(qkv))
    else:
        rc = entry(qkv.data_ptr(), qkv.stride(0), dout.data_ptr(),
                   dout.stride(0), bias.data_ptr(), mask_ptr,
                   dqkv.data_ptr(), dqkv.stride(0), part.data_ptr(),
                   dbias.data_ptr(), b, h, w, c, num_heads, window, shift,
                   plan["group"], plan["smem_bytes"], _build.stream_ptr(qkv))
    _build.check_rc("window_attention_bwd", rc)
    window_attention_bwd.launches_f32 += plan["launches"]


window_attention_bwd.launches = 0
window_attention_bwd.launches_f32 = 0
