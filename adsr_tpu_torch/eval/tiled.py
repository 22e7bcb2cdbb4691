"""Overlapped-tile serving: big-image SR through the tile-sized forward (the
port of ``adsr_tpu/eval/tiled.py``).

The LR image is cut into overlapping tiles of the model's input size, every
tile of the call goes through one forward as one batch, and the SR tiles are
feather-blended: each tile's output is weighted by a pyramid mask that ramps
from 1/(r+1) at the tile border to 1 past the overlap band, the weighted sum
is divided by the summed weight. Tile starts are clamped so the last tile
ends at the image edge. The blend runs on the tensor's device with one
slice-add per tile (never a loop over pixels). A caller that serves many
batches builds the mask once on the device (:func:`feather_weights`) and
passes it in: the blend itself then makes no tensor from host data, so it
can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def tile_starts(size: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, size) with ``tile``-wide tiles overlapping
    by at least ``overlap`` pixels."""
    if size <= tile:
        return [0]
    stride = max(1, tile - overlap)
    starts = list(range(0, size - tile, stride)) + [size - tile]
    return sorted(set(starts))


def feather_mask(tile_hr: int, ramp: int) -> np.ndarray:
    """[tile_hr, tile_hr, 1] f32 weight pyramid: a linear 1/(r+1)..1 ramp of
    width ``ramp`` at each border."""
    axis = np.minimum(np.arange(tile_hr), np.arange(tile_hr)[::-1])
    w = np.minimum((axis + 1.0) / (ramp + 1.0), 1.0)
    return (w[:, None] * w[None, :])[..., None].astype(np.float32)


def feather_weights(tile: int, overlap: int, scale: int,
                    device) -> torch.Tensor:
    """:func:`feather_mask` of a ``tile``-px LR tile at ``scale``, f32 on
    ``device``: one host-to-device copy, made outside any CUDA graph
    capture."""
    return torch.as_tensor(feather_mask(tile * scale, overlap * scale),
                           device=device)


def tiled_sr_forward(tile_forward: Callable[[torch.Tensor], torch.Tensor],
                     lr: torch.Tensor, tile: int, overlap: int,
                     scale: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SR of an LR batch [B, H, W, C] through overlapping [tile, tile] crops.

    ``tile_forward`` maps [N, tile, tile, C] -> [N, tile*scale, tile*scale,
    C] (raw float SR: blending comes before quantisation). ``mask`` is
    :func:`feather_weights` of (``tile``, ``overlap``, ``scale``), built
    here when not given."""
    b, h, w, c = lr.shape
    ys, xs = tile_starts(h, tile, overlap), tile_starts(w, tile, overlap)
    if len(ys) == 1 and len(xs) == 1 and h == tile and w == tile:
        return tile_forward(lr)
    starts = [(y, x) for y in ys for x in xs]
    crops = torch.cat([lr[:, y:y + tile, x:x + tile, :] for y, x in starts])
    sr_tiles = tile_forward(crops)                    # [nt*B, ts, ts, C]
    ts = tile * scale
    if mask is None:
        mask = feather_weights(tile, overlap, scale, sr_tiles.device)
    mask = mask.to(sr_tiles.dtype)
    acc = sr_tiles.new_zeros(b, h * scale, w * scale, c)
    wacc = sr_tiles.new_zeros(1, h * scale, w * scale, 1)
    for i, (y, x) in enumerate(starts):
        rows = slice(y * scale, y * scale + ts)
        cols = slice(x * scale, x * scale + ts)
        acc[:, rows, cols, :] += sr_tiles[i * b:(i + 1) * b] * mask
        wacc[:, rows, cols, :] += mask
    return acc / wacc
