"""The port's evaluation figures and utilities against the JAX package (CPU):
``utils/image.py``, ``utils/profiling.py``, ``metrics.psnr_np``, the jet and
gray tables against matplotlib's, the heatmap PNGs against the JAX maps,
the ROC PDF's curves read back from its content stream against the JAX
``roc_curve``, and ``evaluate_anomaly``'s figures with an ``out_dir``."""

import json
import re
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adsr_tpu.eval.auc import roc_auc as jax_roc_auc
from adsr_tpu.eval.auc import roc_curve as jax_roc_curve
from adsr_tpu.eval.visual import save_heatmaps as jax_save_heatmaps
from adsr_tpu.metrics import psnr_np as jax_psnr_np
from adsr_tpu.metrics import ssim_map as jax_ssim_map
from adsr_tpu.metrics import to_luma as jax_to_luma
from adsr_tpu.utils import image as jax_image
from adsr_tpu.utils.profiling import StepTimer as JaxStepTimer

from adsr_tpu_torch.eval import visual
from adsr_tpu_torch.eval.evaluate import evaluate_anomaly
from adsr_tpu_torch.io import pdf
from adsr_tpu_torch.io.png import read_png
from adsr_tpu_torch.metrics import psnr_np
from adsr_tpu_torch.utils import (StepTimer, histogram_equalization,
                                  min_max_scaling, trace)
from adsr_tpu_torch.utils.profiling import flops_estimate

from test_torch_serving import _experiments, _weights, _write_split

# the card's limit for a heatmap's 1-SSIM panel against a recompute
# elsewhere (chip_smoke.py HEATMAP_EQUAL): every pixel at most one table
# index from it, at least this share equal
HEATMAP_EQUAL = 0.99


# --------------------------------------------------------------------------- #
# utils/ and psnr_np
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["random", "constant", "integers"])
def test_min_max_scaling_matches_jax(kind):
    rng = np.random.RandomState(0)
    x = {"random": rng.randn(7, 9) * 3 + 1,
         "constant": np.full((4, 5), 2.5),
         "integers": rng.randint(0, 255, (6, 6)).astype(np.uint8)}[kind]
    got, want = min_max_scaling(x), jax_image.min_max_scaling(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_histogram_equalization_matches_jax(kind):
    rng = np.random.RandomState(1)
    img = rng.randint(100, 140, (16, 20)).astype(np.uint8) if kind == "uint8" \
        else rng.rand(16, 20).astype(np.float32) ** 3
    got = histogram_equalization(img)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_image.histogram_equalization(img))


@pytest.mark.parametrize("case", ["random", "equal", "data_range"])
def test_psnr_np_matches_jax(case):
    rng = np.random.RandomState(2)
    a = rng.rand(8, 8, 3).astype(np.float32)
    b = a if case == "equal" else np.clip(a + 0.05 * rng.randn(*a.shape), 0, 1)
    kw = {"data_range": 255.0} if case == "data_range" else {}
    got, want = psnr_np(a, b, **kw), jax_psnr_np(a, b, **kw)
    assert got == want
    assert (got == float("inf")) == (case == "equal")


def test_step_timer_splits_like_jax(monkeypatch):
    # both timers on one scripted clock: the same data / model split
    ticks = iter([0.0, 1.5, 4.0, 4.25, 10.0, 0.0, 1.5, 4.0, 4.25, 10.0])
    import time as time_mod
    monkeypatch.setattr(time_mod, "perf_counter", lambda: next(ticks))
    out = []
    for cls in (StepTimer, JaxStepTimer):
        t = cls()
        t.data_done()
        t.model_done()
        t.data_done()
        out.append((t.release(), t.data_acc, t.model_acc))
    assert out[0] == out[1] == ((2.5, 1.75), 0.0, 0.0)


def test_flops_estimate_counts_a_linear():
    lin = torch.nn.Linear(16, 8)
    x = torch.randn(4, 16)
    assert flops_estimate(lin, x) == 2 * 4 * 16 * 8
    assert flops_estimate(lambda t: t + 1, x) is None    # nothing counted


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    lin = torch.nn.Linear(8, 8)
    with trace(str(tmp_path / "tr"), device="cpu"):
        lin(torch.randn(2, 8)).sum().backward()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("addmm" in n for n in names)


# --------------------------------------------------------------------------- #
# Colour tables, the font, the PDF writer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["jet", "gray"])
def test_lut_equals_matplotlib_bytes(name):
    got = {"jet": visual.JET, "gray": visual.GRAY}[name]
    want = matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3]
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_lut_indices_follow_colormap_call():
    rng = np.random.RandomState(3)
    v = rng.rand(9, 11).astype(np.float32) * 5 - 1
    idx = visual.lut_indices(v)
    norm = (v - v.min()) / (v.max() - v.min())
    # Colormap.__call__ on the normalised values picks the same entries
    want = matplotlib.colormaps["jet"](norm, bytes=True)[..., :3]
    np.testing.assert_array_equal(visual.JET[idx], want)
    assert idx.min() == 0 and idx.max() == 255
    assert (visual.lut_indices(np.full((3, 3), 7.0)) == 0).all()


def test_font_has_every_printable_ascii_glyph():
    font = visual._FONT
    assert font.shape == (95, 7, 5)
    assert not font[0].any() and all(font[k].any() for k in range(1, 95))
    assert len({g.tobytes() for g in font}) == 95


def test_helvetica_widths_equal_the_afm():
    afm = Path(matplotlib.get_data_path()) / "fonts" / "afm" / "phvr8a.afm"
    by_name = {n: w for w, n in re.findall(r"WX (\d+) ; N (\w+) ;",
                                           afm.read_text())}
    by_code = dict(re.findall(r"C (\d+) ; WX (\d+) ;", afm.read_text()))
    # WinAnsiEncoding differs from the AFM's StandardEncoding at 39 and 96
    want = [int(by_name["quotesingle"]) if c == 39 else
            int(by_name["grave"]) if c == 96 else int(by_code[str(c)])
            for c in range(32, 127)]
    assert list(pdf.HELVETICA_WIDTHS) == want


def _pdf_objects(data: bytes):
    """{object number: byte offset} from the xref table, checked to point
    at ``N 0 obj``, and the content streams' text."""
    start = int(data.rsplit(b"startxref", 1)[1].split()[0])
    assert data[start:start + 4] == b"xref"
    lines = data[start:].split(b"\n")
    first, count = map(int, lines[1].split())
    assert first == 0 and lines[2] == b"0000000000 65535 f "
    offsets = {}
    for i, line in enumerate(lines[3:3 + count - 1], start=1):
        assert len(line) == 19 and line.endswith(b" 00000 n ")
        offsets[i] = int(line[:10])
        assert data[offsets[i]:].startswith(f"{i} 0 obj\n".encode())
    streams = re.findall(rb"stream\n(.*?)\nendstream", data, re.S)
    return offsets, [s.decode("ascii") for s in streams]


def _paths(content: str):
    """Each stroked polyline op: (rgb, width, dash, [(x, y), ...])."""
    out = []
    for line in content.splitlines():
        m = re.fullmatch(r"(\S+) (\S+) (\S+) RG (\S+) w \[([^\]]*)\] 0 d "
                         r"(.*) S", line)
        if m and " m" in m.group(6):
            nums = [float(t) for t in m.group(6).split() if t not in "ml"]
            out.append((tuple(float(m.group(i)) for i in (1, 2, 3)),
                        float(m.group(4)), m.group(5),
                        list(zip(nums[0::2], nums[1::2]))))
    return out


def _unescape(s: str) -> str:
    return re.sub(r"\\(.)", r"\1", s)


def test_roc_pdf_curves_and_legend_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    y = [0] * 9 + [1] * 7
    sets = {"1-SSIM": rng.rand(16), "MSE": rng.rand(16) + np.array(y) * 0.4,
            "-PSNR": -rng.rand(16) * 30}
    path = visual.save_roc_curves(str(tmp_path / "roc_curve.pdf"), y, sets)
    data = Path(path).read_bytes()
    assert data.startswith(b"%PDF-1.4") and data.endswith(b"%%EOF\n")
    offsets, (content,) = _pdf_objects(data)
    assert len(offsets) == 5           # catalog, pages, font, page, content
    frame = re.search(r"(\S+) (\S+) (\S+) (\S+) re S", content)
    x0, y0, w, h = (float(frame.group(i)) for i in range(1, 5))
    paths = _paths(content)
    for k, (name, scores) in enumerate(sets.items()):
        fpr, tpr, _ = jax_roc_curve(y, scores)
        color = tuple(round(c, 4) for c in pdf.CYCLE[k])
        # the first path in the set's colour is its curve (the legend's
        # sample line comes later)
        pts = next(p[3] for p in paths if p[0] == color and p[1] == 2.0)
        got = np.array([((px - x0) / w * 1.0, (py - y0) / h * 1.05)
                        for px, py in pts])
        np.testing.assert_allclose(got, np.stack([fpr, tpr], 1), atol=1e-3)
    diag = [p for p in paths if p[0] == tuple(round(c, 4) for c in pdf.NAVY)]
    assert len(diag) == 1 and diag[0][2] == "7.400 3.200"
    texts = [_unescape(t) for t in re.findall(r"\((.*?)\) Tj", content)]
    labels = [f"{n} (AUC = {jax_roc_auc(y, s):.2f})" for n, s in sets.items()]
    assert [t for t in texts if "AUC" in t] == labels
    assert {"False Positive Rate", "True Positive Rate",
            "Receiver Operating Characteristic (ROC) Curve"} <= set(texts)


# --------------------------------------------------------------------------- #
# Heatmaps
# --------------------------------------------------------------------------- #

def _jax_maps(hr_u8, sr_u8, window):
    hr = hr_u8.astype(np.float32) / 255.0
    sr = sr_u8.astype(np.float32) / 255.0
    smap = np.asarray(jax_ssim_map(jax_to_luma(jnp.asarray(hr)),
                                   jax_to_luma(jnp.asarray(sr)),
                                   window, 0.01 ** 2, 0.03 ** 2, "reflect"))
    diffs = [jax_image.min_max_scaling(np.abs(a - b).mean(axis=-1))
             for a, b in zip(hr, sr)]
    return diffs, 1.0 - smap[..., 0]


@pytest.mark.parametrize("channels", [1, 3])
def test_heatmaps_match_jax(tmp_path, channels):
    # the JAX test's inputs (tests/test_eval.py:125-134), and RGB
    rng = np.random.RandomState(0)
    hr = (rng.rand(3, 24, 24, channels) * 255).astype(np.uint8)
    sr = (rng.rand(3, 24, 24, channels) * 255).astype(np.uint8)
    names, splits = ["a", "b", "c"], ["good", "bad", "bad"]
    want_n = jax_save_heatmaps(str(tmp_path / "jax"), hr, sr, names, splits,
                               window=5, max_images=1)
    n = visual.save_heatmaps(str(tmp_path / "port"), hr, sr, names, splits,
                             window=5, max_images=1, device="cpu")

    def files(root):
        return sorted(str(p.relative_to(root / "heatmaps"))
                      for p in (root / "heatmaps").rglob("*.png"))
    assert n == want_n == 2
    assert files(tmp_path / "port") == files(tmp_path / "jax") == \
        ["bad/b.png", "good/a.png"]
    diffs, one_minus = _jax_maps(hr, sr, 5)
    for i, rel in ((0, "good/a.png"), (1, "bad/b.png")):
        fig = read_png(tmp_path / "port" / "heatmaps" / rel)
        assert fig.shape == visual.heatmap_layout(24, 24, 5)["size"] + (3,)
        shown = visual.heatmap_panel(fig, 24, 24, 5, 0)
        want_sr = visual.GRAY[visual.lut_indices(sr[i, :, :, 0])] \
            if channels == 1 else sr[i]
        np.testing.assert_array_equal(shown, want_sr)
        np.testing.assert_array_equal(
            visual.heatmap_panel(fig, 24, 24, 5, 1),
            visual.JET[visual.lut_indices(diffs[i])])
        equal, near = visual.index_agreement(
            visual.heatmap_panel(fig, 24, 24, 5, 2),
            visual.lut_indices(one_minus[i]))
        assert near and equal >= HEATMAP_EQUAL


def test_heatmap_layout_zooms_small_images_only():
    small = visual.heatmap_layout(24, 20, 5)
    assert small["zoom"] == 5 and small["text"] == 1
    big = visual.heatmap_layout(512, 512, 13)
    assert big["zoom"] == 1 and big["text"] == 2
    for lay, (h, w) in ((small, (24, 20)), (big, (512, 512))):
        z = lay["zoom"]
        ys, xs = zip(*lay["panels"])
        assert all(xs[k] + w * z <= xs[k + 1] for k in range(2))
        assert max(ys) + h * z <= lay["size"][0]
        assert xs[2] + w * z + lay["bars"][1][2] <= lay["size"][1]


# --------------------------------------------------------------------------- #
# evaluate_anomaly with an out_dir
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("save_images", [True, False])
def test_evaluate_anomaly_writes_the_figures(tmp_path, save_images):
    _, pexp = _experiments()
    _, sd = _weights()
    rng = np.random.RandomState(1)
    _write_split(tmp_path / "data", "good", 6, rng, defect=False)
    _write_split(tmp_path / "data", "bad", 5, rng, defect=True)
    out = tmp_path / "out"
    logs = []
    res = evaluate_anomaly(pexp, sd, str(tmp_path / "data"), "grid",
                           out_dir=str(out), save_images=save_images, batch=4,
                           device="cpu", log=logs.append)
    assert (out / "roc_curve.pdf").read_bytes().startswith(b"%PDF")
    assert sorted(p.name for p in (out / "heatmaps" / "good").iterdir()) == \
        [f"{i:03d}.png" for i in range(6)]
    assert len(list((out / "heatmaps" / "bad").iterdir())) == 5
    assert (out / "good").exists() == save_images
    assert f"Saved ROC curve and 11 heatmap figures to {out}" in logs
    assert res["figures_s"] > 0
