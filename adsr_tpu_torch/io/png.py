"""The port's PNG codec: numpy and the standard library's ``zlib``, no PIL.

The card's machine has neither PIL nor libpng (the JAX package decodes with
PIL or ``native/adsr_native.cpp``, which includes ``<png.h>``), so the port
reads and writes its datasets, run-dir images and evaluation dumps here, on
every device.

``read_png`` takes non-interlaced 8-bit gray, gray + alpha, RGB, RGBA and
palette images (palettes also at 1, 2 or 4 bits) with all five row filters,
and returns the array ``np.asarray(PIL.Image.open(path))`` gives: [H, W] for
gray and palette (the palette indices, as PIL's mode "P"), [H, W, C]
otherwise, uint8. ``read_png_rgb`` returns what
``PIL.Image.open(path).convert("RGB")`` gives for the same files: gray
replicated to three channels, alpha dropped, palette indices looked up in
the ``PLTE`` chunk. A 16-bit, low-bit gray or interlaced file raises a
``ValueError`` that names the file, as does a palette image without a
``PLTE`` chunk or with an index past its end. ``write_png`` writes 8-bit
gray and RGB.

Unfiltering: rows with the None, Sub and Up filters are undone a row at a
time with whole-row numpy operations; an image with an Average or Paeth row
(each byte depends on its reconstructed left neighbour) is undone along
anti-diagonals, where every pixel of a diagonal depends only on the
previous two diagonals, so each step is one vectorised operation over the
diagonal.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}    # colour type -> samples a pixel

PathLike = Union[str, Path]


def _unfilter_rows(ftypes: np.ndarray, data: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Rows filtered with None (0), Sub (1) or Up (2) only."""
    h, stride = data.shape
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        row = data[y].astype(np.int32)
        t = ftypes[y]
        if t == 1:
            row = row.reshape(-1, bpp).cumsum(axis=0).reshape(-1)
        elif t == 2:
            row = row + prev
        prev = out[y] = row & 255
    return out


def _unfilter_diagonals(ftypes: np.ndarray, data: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any filter mix: pixel units (``bpp`` bytes) along anti-diagonals."""
    h, stride = data.shape
    units = stride // bpp
    d = data.reshape(h, units, bpp).astype(np.int32)
    out = np.zeros((h + 1, units + 1, bpp), np.int32)   # zero row and unit
    for s in range(h + units - 1):
        ys = np.arange(max(0, s - units + 1), min(h, s + 1))
        xs = s - ys
        a = out[ys + 1, xs]          # left
        b = out[ys, xs + 1]          # up
        c = out[ys, xs]              # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftypes[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (d[ys, xs] + pred) & 255
    return out[1:, 1:].reshape(h, stride)


def _decode(path: PathLike):
    """(the array ``read_png`` returns, the colour type, the PLTE body or
    None)."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat, plte = 8, None, [], None
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if color not in _CHANNELS or not (
            depth == 8 or (color == 3 and depth in (1, 2, 4))):
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {color} is "
                         "not supported (8-bit gray, gray+alpha, RGB, RGBA "
                         "or palette)")
    ch = _CHANNELS[color]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    ftypes, body = rows[:, 0], rows[:, 1:]
    if h and ftypes.max() > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftypes.max())}")
    if np.isin(ftypes, (3, 4)).any():
        pix = _unfilter_diagonals(ftypes, body, bpp)
    else:
        pix = _unfilter_rows(ftypes, body, bpp)
    pix = pix.astype(np.uint8)
    if depth < 8:                   # palette indices packed MSB first
        bits_row = np.unpackbits(pix, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        idx = (bits_row * weights).sum(axis=2).astype(np.uint8)[:, :w]
        return idx, color, plte
    img = pix.reshape(h, w, ch)
    return (img[:, :, 0] if ch == 1 else img), color, plte


def read_png(path: PathLike) -> np.ndarray:
    """Decode a PNG file to the uint8 array PIL's ``np.asarray`` gives."""
    return _decode(path)[0]


def read_png_rgb(path: PathLike) -> np.ndarray:
    """Decode a PNG file to the uint8 [H, W, 3] array that
    ``PIL.Image.open(path).convert("RGB")`` gives."""
    img, color, plte = _decode(path)
    if color == 0:                                  # gray
        return np.repeat(img[:, :, None], 3, axis=2)
    if color == 4:                                  # gray + alpha
        return np.repeat(img[:, :, :1], 3, axis=2)
    if color == 6:                                  # RGBA
        return np.ascontiguousarray(img[:, :, :3])
    if color == 3:
        if plte is None or len(plte) % 3 or not plte:
            raise ValueError(f"{path}: palette image without a valid PLTE "
                             "chunk")
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if img.size and int(img.max()) >= len(palette):
            raise ValueError(f"{path}: palette index {int(img.max())} past "
                             f"the {len(palette)} PLTE entries")
        return palette[img]
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: PathLike, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 [H, W], [H, W, 1] (8-bit gray) or [H, W, 3] (RGB)
    image, every row with filter None, deflated at zlib ``level``."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"{path}: write_png takes uint8 gray or RGB, got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    color = 0 if a.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)],
                          axis=1)
    Path(path).write_bytes(
        SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b""))
