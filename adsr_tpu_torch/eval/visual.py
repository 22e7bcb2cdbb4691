"""Evaluation figures: ROC curves and difference / SSIM heatmaps (the port of
``adsr_tpu/eval/visual.py``, the same functions, file names and counts).

The JAX package draws both with matplotlib, which the card's machine lacks.
Here the ROC figure is a vector PDF through ``io/pdf.py`` in the JAX layout,
and each heatmap is a PNG through ``io/png.py`` with three panels at the
image's own pixels (scaled up by a whole factor, nearest neighbour, never
resampled): the SR, the min-max scaled |HR - SR| and the 1-SSIM map, each
data panel normalised by its own minimum and maximum and coloured through
matplotlib's jet, as ``imshow`` does, titles and the colour bars' end values
in a built-in 5x7 bitmap font.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.device import resolve_device
from adsr_tpu_torch.eval.auc import roc_auc, roc_curve
from adsr_tpu_torch.io.pdf import (CYCLE, DASHED, NAVY, Axes, Page,
                                   write_pdf)
from adsr_tpu_torch.io.png import write_png
from adsr_tpu_torch.metrics import ssim_map, to_luma
from adsr_tpu_torch.utils.image import min_max_scaling

# matplotlib's segment data (matplotlib/_cm.py) for "jet" and "gray":
# per channel, (x, y below x, y above x) breakpoints
JET_SEGMENTS = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}
GRAY_SEGMENTS = {c: ((0.0, 0, 0), (1.0, 1, 1))
                 for c in ("red", "green", "blue")}


def segment_lut(segments: Dict[str, Sequence], n: int = 256) -> np.ndarray:
    """The [n, 3] uint8 table of a segmented colour map, computed as
    matplotlib's ``LinearSegmentedColormap`` builds it and
    ``Colormap.__call__(..., bytes=True)`` converts it (f64, truncated)."""
    out = []
    for channel in ("red", "green", "blue"):
        data = np.asarray(segments[channel], dtype=float)
        x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]],
                              distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                              [y0[-1]]])
        out.append((np.clip(lut, 0.0, 1.0) * 255).astype(np.uint8))
    return np.stack(out, axis=1)


JET = segment_lut(JET_SEGMENTS)
GRAY = segment_lut(GRAY_SEGMENTS)


def lut_indices(values: np.ndarray) -> np.ndarray:
    """Colour-table indices of a panel: normalised by its own minimum and
    maximum in f32 (a constant panel maps to 0), then ``int(v * 256)``
    clipped to 255, as ``Colormap.__call__`` indexes."""
    v = np.asarray(values, dtype=np.float32)
    lo, hi = v.min(), v.max()
    v = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    return np.minimum((v * np.float32(256)).astype(np.int64), 255)


# 5x7 glyphs of the printable ASCII characters 32-126, in order: seven rows
# of five bits a glyph, two hex digits a row, the leftmost pixel the 0x10 bit
_GLYPHS = """
00000000000000 04040404040004 0A0A0A00000000 0A0A1F0A1F0A0A 040F140E051E04
18190204081303 0C12140815120D 04040800000000 02040808080402 08040202020408
0004150E150400 0004041F040400 000000000C0408 0000001F000000 00000000000C0C
00010204081000 0E11131519110E 040C040404040E 0E11010204081F 1F02040201110E
02060A121F0202 1F101E0101110E 0608101E11110E 1F010204080808 0E11110E11110E
0E11110F01020C 000C0C000C0C00 000C0C000C0408 02040810080402 00001F001F0000
08040201020408 0E110102040004 0E11010D15150E 0E1111111F1111 1E11111E11111E
0E11101010110E 1C12111111121C 1F10101E10101F 1F10101E101010 0E11101711110F
1111111F111111 0E04040404040E 0702020202120C 11121418141211 1010101010101F
111B1515111111 11111915131111 0E11111111110E 1E11111E101010 0E11111115120D
1E11111E141211 0F10100E01011E 1F040404040404 1111111111110E 11111111110A04
1111111515150A 11110A040A1111 1111110A040404 1F01020408101F 0E08080808080E
00100804020100 0E02020202020E 040A1100000000 0000000000001F 08040200000000
00000E010F110F 1010161911111E 00000E1010110E 01010D1311110F 00000E111F100E
0609081C080808 000F11110F010E 10101619111111 04000C0404040E 0200060202120C
10101214181412 0C04040404040E 00001A15151111 00001619111111 00000E1111110E
00001E111E1010 00000D130F0101 00001619101010 00000E100E011E 08081C08080906
0000111111130D 00001111110A04 0000111115150A 0000110A040A11 000011110F010E
00001F0204081F 02040408040402 04040404040404 08040402040408 00000815020000
"""
_FONT = np.array([[[(int(g[2 * r:2 * r + 2], 16) >> (4 - c)) & 1
                    for c in range(5)] for r in range(7)]
                  for g in _GLYPHS.split()], dtype=bool)


def _draw_text(canvas: np.ndarray, y: int, x: int, s: str, scale: int
               ) -> None:
    """Black ``s`` with its top-left corner at (y, x), each font pixel
    ``scale`` x ``scale``, six font pixels a character."""
    for i, ch in enumerate(s):
        code = ord(ch) - 32 if " " <= ch <= "~" else ord("?") - 32
        glyph = np.kron(_FONT[code], np.ones((scale, scale), dtype=bool))
        x0 = x + 6 * scale * i
        region = canvas[y:y + 7 * scale, x0:x0 + 5 * scale]
        region[glyph[:region.shape[0], :region.shape[1]]] = 0


MARGIN = 8
LABEL_CHARS = 9          # "-1.23e-05", the longest ".3g" label


def heatmap_layout(h: int, w: int, window: int) -> Dict[str, object]:
    """Where the figure of an h x w image puts things: ``zoom`` (the whole
    factor a panel pixel is scaled up by: 128 // max(h, w), at least 1),
    ``text`` (the font's scale), ``size`` (canvas height, width),
    ``titles`` with the x where each starts (centred on its column),
    ``panels`` (each panel's top-left (y, x); each is h * zoom x w * zoom)
    and ``bars`` (the two colour bars' top-left and width)."""
    zoom = max(1, 128 // max(h, w))
    ph, pw = h * zoom, w * zoom
    text = max(1, ph // 256)
    char_w, char_h = 6 * text, 7 * text
    bar_w = max(8, pw // 24)
    titles = ("SR reconstruction", "|HR - SR| (min-max scaled)",
              f"1 - SSIM map (ws={window})")
    top = MARGIN + char_h + 6
    x, title_x, panels, bars = MARGIN, [], [], []
    for k, title in enumerate(titles):
        content = pw if k == 0 else pw + 6 + bar_w + 4 + LABEL_CHARS * char_w
        col = max(content, len(title) * char_w)
        px = x + (col - content) // 2
        title_x.append(x + (col - len(title) * char_w) // 2)
        panels.append((top, px))
        if k:
            bars.append((top, px + pw + 6, bar_w))
        x += col + 2 * MARGIN
    return {"zoom": zoom, "text": text, "titles": list(zip(titles, title_x)),
            "panels": panels, "bars": bars,
            "size": (top + ph + MARGIN, x - MARGIN)}


def render_heatmap(sr_u8: np.ndarray, diff: np.ndarray,
                   one_minus_ssim: np.ndarray, window: int) -> np.ndarray:
    """The [H, W, 3] uint8 figure of one image: the SR ([h, w, 1] grey
    through the gray map, [h, w, 3] as it is), ``diff`` and
    ``one_minus_ssim`` ([h, w] each) through jet, each with a colour bar
    labelled with its panel's minimum and maximum."""
    h, w = sr_u8.shape[:2]
    lay = heatmap_layout(h, w, window)
    zoom, text = lay["zoom"], lay["text"]
    canvas = np.full(lay["size"] + (3,), 255, dtype=np.uint8)
    shown = GRAY[lut_indices(sr_u8[:, :, 0])] if sr_u8.shape[-1] == 1 \
        else sr_u8
    panels = (shown, JET[lut_indices(diff)], JET[lut_indices(one_minus_ssim)])
    ph = h * zoom
    for (y, x), (title, tx), img in zip(lay["panels"], lay["titles"], panels):
        big = np.repeat(np.repeat(img, zoom, axis=0), zoom, axis=1)
        canvas[y:y + ph, x:x + w * zoom] = big
        _draw_text(canvas, MARGIN, tx, title, text)
    ramp = JET[255 - (np.arange(ph) * 256 // ph)]
    for (y, x, bar_w), values in zip(lay["bars"], (diff, one_minus_ssim)):
        canvas[y:y + ph, x:x + bar_w] = ramp[:, None, :]
        _draw_text(canvas, y, x + bar_w + 4, f"{values.max():.3g}", text)
        _draw_text(canvas, y + ph - 7 * text, x + bar_w + 4,
                   f"{values.min():.3g}", text)
    return canvas


def save_roc_curves(path: str, y_true: Sequence[int],
                    score_sets: Dict[str, Sequence[float]]) -> str:
    """One ROC figure with a curve per score set (AUC in the legend), in
    the reference's layout (helpers.py:440-449): the dashed chance diagonal,
    [0, 1] x [0, 1.05] limits, FPR / TPR axes, the legend lower right. A
    6 x 5 inch vector PDF."""
    page = Page(432.0, 360.0)
    ax = Axes(page, (54.0, 42.0, 422.0, 330.0), (0.0, 1.0), (0.0, 1.05))
    ax.decorate("Receiver Operating Characteristic (ROC) Curve",
                "False Positive Rate", "True Positive Rate")
    entries = []
    for k, (name, scores) in enumerate(score_sets.items()):
        fpr, tpr, _ = roc_curve(y_true, scores)
        auc = roc_auc(y_true, scores)
        color = CYCLE[k % len(CYCLE)]
        ax.plot(fpr, tpr, color, width=2.0)
        entries.append((f"{name} (AUC = {auc:.2f})", color, 2.0, ()))
    ax.plot([0.0, 1.0], [0.0, 1.0], NAVY, width=2.0, dash=DASHED)
    ax.legend(entries, "lower right")
    write_pdf(path, [page])
    return path


@torch.no_grad()
def one_minus_ssim(hr_u8: np.ndarray, sr_u8: np.ndarray, window: int,
                   device="cuda") -> np.ndarray:
    """[N, H, W] per-pixel 1-SSIM of uint8 [N, H, W, C] pairs on
    ``device`` in one batched call: luma, reflect padding, c1 = 0.01^2,
    c2 = 0.03^2 (the heatmaps' map)."""
    dev = resolve_device(device)
    a = to_luma(torch.as_tensor(hr_u8, device=dev).float() / 255.0)
    b = to_luma(torch.as_tensor(sr_u8, device=dev).float() / 255.0)
    m = ssim_map(a, b, window, 0.01 ** 2, 0.03 ** 2, "reflect")
    return (1.0 - m[..., 0]).cpu().numpy()


def save_heatmaps(out_dir: str, hr_u8: np.ndarray, sr_u8: np.ndarray,
                  filenames: Sequence[str], splits: Sequence[str],
                  window: int = 11, max_images: int = 16,
                  device="cuda") -> int:
    """Per-image |HR-SR| difference and 1-SSIM heatmaps (test.ipynb 11-21)
    as ``out_dir/heatmaps/{split}/{name}.png``: the first ``max_images``
    of each split, in order. The SSIM maps of those images only are
    computed, in one call on ``device`` (the JAX version maps every image;
    one image's map does not depend on the others). Returns the count."""
    budget = {s: max_images for s in set(splits)}
    chosen = []
    for i, split in enumerate(splits[:len(filenames)]):
        if budget[split] > 0:
            budget[split] -= 1
            chosen.append(i)
    if not chosen:
        return 0
    smap = one_minus_ssim(hr_u8[chosen], sr_u8[chosen], window, device)
    hr = hr_u8[chosen].astype(np.float32) / 255.0
    sr = sr_u8[chosen].astype(np.float32) / 255.0
    for k, i in enumerate(chosen):
        diff = min_max_scaling(np.abs(hr[k] - sr[k]).mean(axis=-1))
        d = Path(out_dir) / "heatmaps" / splits[i]
        d.mkdir(parents=True, exist_ok=True)
        # zlib level 1: level 6's deflate is most of a figure's host time,
        # for files only a little smaller
        write_png(d / f"{filenames[i]}.png",
                  render_heatmap(sr_u8[i], diff, smap[k], window), level=1)
    return len(chosen)


def heatmap_panel(figure: np.ndarray, h: int, w: int, window: int,
                  k: int) -> np.ndarray:
    """Panel ``k`` (0 SR, 1 |HR - SR|, 2 1-SSIM) of a decoded heatmap of an
    h x w image, back at the image's pixels: [h, w, 3]."""
    lay = heatmap_layout(h, w, window)
    (y, x), z = lay["panels"][k], lay["zoom"]
    return figure[y:y + h * z:z, x:x + w * z:z]


def index_agreement(colours: np.ndarray, want: np.ndarray,
                    lut: np.ndarray = JET) -> Tuple[float, bool]:
    """A drawn panel's colours ([h, w, 3]) against table indices ``want``
    ([h, w]): the share of pixels drawn as ``lut[want]``, and whether every
    pixel is ``lut[want + d]`` for some |d| <= 1."""
    def drawn_as(idx):
        return (colours == lut[np.clip(idx, 0, len(lut) - 1)]).all(axis=-1)
    equal = drawn_as(want)
    near = equal | drawn_as(want - 1) | drawn_as(want + 1)
    return float(equal.mean()), bool(near.all())
