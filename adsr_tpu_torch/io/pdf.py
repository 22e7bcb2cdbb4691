"""A small vector PDF writer for the port's figures: the ROC curves
(``eval/visual.py``) and the run dir's loss and PSNR/SSIM curves
(``io/journal.py``), which the JAX package draws with matplotlib, absent on
the card's machine.

A page holds polylines (solid or dashed), rectangles and text in the base-14
Helvetica (not embedded: every PDF reader has it). Each page's content stream
is uncompressed, so its coordinates read back as text. ``Axes`` maps data to
page coordinates and draws a frame, ticks, labels and a legend in the layout
of matplotlib's defaults. Units are PDF points (1/72 inch), origin bottom
left.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

Color = Tuple[float, float, float]
BLACK: Color = (0.0, 0.0, 0.0)
NAVY: Color = (0.0, 0.0, 128 / 255)
GRID: Color = (176 / 255,) * 3
# matplotlib's default colour cycle, C0, C1, ...
CYCLE: Tuple[Color, ...] = tuple(
    tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4))
    for h in ("1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd", "8c564b",
              "e377c2", "7f7f7f", "bcbd22", "17becf"))
# matplotlib's "--" at a line width w: dashes of 3.7 w, gaps of 1.6 w
DASHED = (3.7, 1.6)

# Helvetica's advance widths in 1/1000 em (Adobe's Helvetica AFM) of the
# WinAnsiEncoding codes 32-126, the text this writer draws
HELVETICA_WIDTHS = (
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333,
    278, 278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278,
    584, 584, 584, 556, 1015, 667, 667, 722, 722, 667, 611, 778, 722, 278,
    500, 667, 556, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944,
    667, 667, 611, 278, 278, 278, 469, 556, 333, 556, 556, 500, 556, 556,
    278, 556, 556, 222, 222, 500, 222, 833, 556, 556, 556, 556, 333, 500,
    278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)


def _printable(s: str) -> str:
    return "".join(c if " " <= c <= "~" else "?" for c in s)


def text_width(s: str, size: float) -> float:
    """Width in points of ``s`` set in Helvetica at ``size``."""
    return sum(HELVETICA_WIDTHS[ord(c) - 32] for c in _printable(s)) \
        * size / 1000.0


def _rgb(c: Color) -> str:
    return " ".join(f"{v:.4f}" for v in c)


class Page:
    """One page: drawing operators appended in painting order."""

    def __init__(self, width: float, height: float):
        self.width, self.height = width, height
        self.ops: List[str] = []

    def polyline(self, points: Sequence[Tuple[float, float]],
                 color: Color = BLACK, width: float = 1.0,
                 dash: Sequence[float] = ()) -> None:
        """A stroked open path through ``points`` (one op line: colour,
        width, dash pattern, ``m``/``l`` points, ``S``)."""
        if len(points) < 2:
            return
        path = " ".join(f"{x:.3f} {y:.3f} {'l' if i else 'm'}"
                        for i, (x, y) in enumerate(points))
        pattern = " ".join(f"{d:.3f}" for d in dash)
        self.ops.append(f"{_rgb(color)} RG {width:.3f} w [{pattern}] 0 d "
                        f"{path} S")

    def rect(self, x: float, y: float, w: float, h: float,
             stroke: Color = BLACK, fill: Optional[Color] = None,
             width: float = 1.0) -> None:
        fill_op = "" if fill is None else f"{_rgb(fill)} rg "
        self.ops.append(f"{fill_op}{_rgb(stroke)} RG {width:.3f} w [] 0 d "
                        f"{x:.3f} {y:.3f} {w:.3f} {h:.3f} re "
                        f"{'S' if fill is None else 'B'}")

    def text(self, x: float, y: float, s: str, size: float = 10.0,
             anchor: str = "left", rotate: bool = False,
             color: Color = BLACK) -> None:
        """``s`` with its baseline's ``anchor`` point ("left", "center",
        "right") at (x, y); ``rotate`` turns it 90 degrees counter-clockwise
        (a y axis label)."""
        s = _printable(s)
        shift = {"left": 0.0, "center": 0.5, "right": 1.0}[anchor] \
            * text_width(s, size)
        cos, sin = (0.0, 1.0) if rotate else (1.0, 0.0)
        body = s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
        self.ops.append(f"BT /F1 {size:.3f} Tf {_rgb(color)} rg {cos:g} "
                        f"{sin:g} {-sin:g} {cos:g} {x - shift * cos:.3f} "
                        f"{y - shift * sin:.3f} Tm ({body}) Tj ET")


def write_pdf(path, pages: Sequence[Page]) -> None:
    """Write ``pages`` as a PDF 1.4 file: catalog, page tree, the font, then
    each page and its content stream, and a cross-reference table of every
    object's byte offset."""
    n = len(pages)
    kids = " ".join(f"{4 + 2 * i} 0 R" for i in range(n))
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            f"<< /Type /Pages /Kids [{kids}] /Count {n} >>".encode(),
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
            b"/Encoding /WinAnsiEncoding >>"]
    for i, page in enumerate(pages):
        content = "\n".join(page.ops).encode("ascii")
        objs.append(f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
                    f"{page.width:.3f} {page.height:.3f}] /Resources << "
                    f"/Font << /F1 3 0 R >> >> /Contents {5 + 2 * i} 0 R >>"
                    .encode())
        objs.append(f"<< /Length {len(content)} >>\nstream\n".encode()
                    + content + b"\nendstream")
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
    start = len(out)
    out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    out += "".join(f"{o:010d} 00000 n \n" for o in offsets).encode()
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
            f"startxref\n{start}\n%%EOF\n").encode()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(bytes(out))


def data_limits(values: Sequence[float], margin: float = 0.05
                ) -> Tuple[float, float]:
    """Autoscaled axis limits: the finite values' range widened by
    ``margin`` of it on each side (matplotlib's default margins)."""
    finite = [float(v) for v in values if math.isfinite(v)]
    if not finite:
        return 0.0, 1.0
    lo, hi = min(finite), max(finite)
    pad = margin * (hi - lo) if hi > lo else (0.05 * abs(lo) or 0.5)
    return lo - pad, hi + pad


def ticks(lo: float, hi: float, target: int = 6) -> Tuple[List[float], int]:
    """Tick values at a step of 1, 2, 2.5 or 5 times a power of ten, about
    ``target`` of them in [lo, hi], and the decimals that print them."""
    raw = (hi - lo) / target
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw * 0.999)
    k0 = math.ceil(lo / step - 1e-9)
    vals = [round((k0 + k) * step, 12)
            for k in range(int((hi - k0 * step) / step + 1e-9) + 1)]
    decimals = next((d for d in range(12)
                     if all(abs(round(v, d) - v) < 1e-9 * max(1.0, abs(v))
                            for v in vals)), 12)
    return vals, decimals


class Axes:
    """A plot area of ``page``: ``box`` = (x0, y0, x1, y1) in points shows
    ``xlim`` x ``ylim`` in data units."""

    def __init__(self, page: Page, box: Tuple[float, float, float, float],
                 xlim: Tuple[float, float], ylim: Tuple[float, float]):
        self.page, self.box, self.xlim, self.ylim = page, box, xlim, ylim

    def to_page(self, x: float, y: float) -> Tuple[float, float]:
        (x0, y0, x1, y1), (a, b), (c, d) = self.box, self.xlim, self.ylim
        return (x0 + (x - a) / (b - a) * (x1 - x0),
                y0 + (y - c) / (d - c) * (y1 - y0))

    def plot(self, xs: Sequence[float], ys: Sequence[float], color: Color,
             width: float = 1.5, dash: Sequence[float] = ()) -> None:
        """A line through the points; a non-finite value breaks it."""
        run: List[Tuple[float, float]] = []
        for x, y in list(zip(xs, ys)) + [(math.nan, math.nan)]:
            if math.isfinite(x) and math.isfinite(y):
                run.append(self.to_page(float(x), float(y)))
                continue
            self.page.polyline(run, color, width,
                               tuple(d * width for d in dash))
            run = []

    def decorate(self, title: str, xlabel: str, ylabel: str,
                 grid: bool = False) -> None:
        """Grid (under the data), frame, outward ticks with their labels,
        axis labels and title."""
        x0, y0, x1, y1 = self.box
        p = self.page
        xt, xd = ticks(*self.xlim)
        yt, yd = ticks(*self.ylim)
        for v in xt:
            x = self.to_page(v, self.ylim[0])[0]
            if grid:
                p.polyline([(x, y0), (x, y1)], GRID, 0.8)
            p.polyline([(x, y0), (x, y0 - 3.5)], BLACK, 0.8)
            p.text(x, y0 - 14, f"{v:.{xd}f}", 10, "center")
        for v in yt:
            y = self.to_page(self.xlim[0], v)[1]
            if grid:
                p.polyline([(x0, y), (x1, y)], GRID, 0.8)
            p.polyline([(x0, y), (x0 - 3.5, y)], BLACK, 0.8)
            p.text(x0 - 6, y - 3.5, f"{v:.{yd}f}", 10, "right")
        p.rect(x0, y0, x1 - x0, y1 - y0, BLACK, None, 0.8)
        p.text((x0 + x1) / 2, y0 - 30, xlabel, 10, "center")
        label_x = x0 - 12 - max(text_width(f"{v:.{yd}f}", 10) for v in yt)
        p.text(label_x, (y0 + y1) / 2, ylabel, 10, "center", rotate=True)
        p.text((x0 + x1) / 2, y1 + 8, title, 12, "center")

    def legend(self, entries: Sequence[Tuple[str, Color, float,
                                             Sequence[float]]],
               loc: str = "upper right") -> None:
        """A boxed legend in the ``loc`` corner ("upper right", "lower
        right"): a line sample and its label for each (label, colour,
        width, dash)."""
        x0, y0, x1, y1 = self.box
        size, row, pad, sample = 10.0, 14.0, 5.0, 20.0
        w = 2 * pad + sample + 6 + max(text_width(e[0], size)
                                       for e in entries)
        h = 2 * pad + row * len(entries) - 4
        left = x1 - 6 - w
        bottom = y0 + 6 if loc == "lower right" else y1 - 6 - h
        self.page.rect(left, bottom, w, h, (0.8, 0.8, 0.8), (1.0, 1.0, 1.0))
        for i, (label, color, width, dash) in enumerate(entries):
            y = bottom + h - pad - row * i - 7
            self.page.polyline([(left + pad, y), (left + pad + sample, y)],
                               color, width, tuple(d * width for d in dash))
            self.page.text(left + pad + sample + 6, y - 3.5, label, size)


def line_panel(page: Page, box: Tuple[float, float, float, float],
               xs: Sequence[float], ys: Sequence[float], title: str,
               xlabel: str, ylabel: str, label: str) -> Axes:
    """One autoscaled, gridded line plot with a one-entry legend (the
    journal's loss and PSNR/SSIM panels)."""
    ax = Axes(page, box, data_limits(xs), data_limits(ys))
    ax.decorate(title, xlabel, ylabel, grid=True)
    ax.plot(xs, ys, CYCLE[0])
    ax.legend([(label, CYCLE[0], 1.5, ())])
    return ax
