"""The port's dataset preparation against Pillow and the JAX package on the
CPU: the numpy LANCZOS resampler byte for byte against
``PIL.Image.resize(..., LANCZOS)`` and the JAX ``lr_from_hr``, the PNG
decoder's RGB conversion against ``PIL...convert("RGB")`` and the JAX
``resize_image``, and ``prepare_mvtec_dataset``, ``verify_dataset_structure``,
``expand_scales`` and ``cli.prepare`` against the JAX ones (their default
PIL path) on one source tree: the same file lists and bit-equal decoded
pixels."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from adsr_tpu.cli import prepare as jcli
from adsr_tpu.data import prepare as jprep

from adsr_tpu_torch.cli import prepare as pcli
from adsr_tpu_torch.data import prepare as pprep
from adsr_tpu_torch.io.png import read_png, read_png_rgb

# (source width, height) -> (target width, height): the sizes real MVTec
# images and the resampler's edges give (downscales by integer and
# non-integer factors, a non-square source, upscales) ...
SIZES = [((1024, 1024), (128, 128)), ((1024, 1024), (512, 512)),
         ((900, 900), (256, 256)), ((700, 1024), (256, 256)),
         ((256, 256), (32, 32)), ((128, 128), (16, 16)),
         ((300, 200), (128, 128)), ((64, 64), (128, 128)),
         ((64, 64), (256, 256))]
# ... and every LR the prep tool writes: --hr-size x {2, 4, 8}
HR_LR = [(hr, s) for hr in (512, 256, 128, 64, 32) for s in (2, 4, 8)]


def _images(w, h, channels, seed):
    """A uniform-noise image and a smooth one (mid-range values, where
    rounding decides), uint8 [h, w] or [h, w, 3]."""
    rng = np.random.RandomState(seed)
    shape = (h, w) if channels == 1 else (h, w, 3)
    noise = rng.randint(0, 256, shape).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    smooth = 127.5 + 120 * np.sin(x / 17.0 + rng.rand()) * np.cos(y / 23.0)
    if channels == 3:
        smooth = np.stack([smooth, 255 - smooth, smooth[::-1, ::-1]], -1)
    return noise, smooth.astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("src,dst", SIZES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in SIZES])
def test_resize_lanczos_is_pillow_exact(src, dst, channels):
    for img in _images(*src, channels, seed=src[0] + dst[0]):
        want = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
        got = pprep.resize_lanczos(img, *dst)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("hr,scale", HR_LR, ids=[f"{h}x{s}" for h, s in HR_LR])
def test_lr_from_hr_equals_jax(hr, scale, channels):
    for img in _images(hr, hr, channels, seed=hr * scale):
        want = np.asarray(jprep.lr_from_hr(Image.fromarray(img), scale))
        got = pprep.lr_from_hr(img, scale)
        assert got.shape == (hr // scale, hr // scale) + img.shape[2:]
        assert np.array_equal(got, want)


def test_lanczos_taps_are_cached_and_read_only():
    a = pprep.lanczos_taps(300, 128)
    assert a is pprep.lanczos_taps(300, 128)
    assert not a.flags.writeable
    # each row's integer taps sum to 2^22 within the rounding of its taps
    assert np.all(np.abs(a.sum(axis=1) - 2 ** 22) <= a.shape[1])


def test_resize_lanczos_refuses_other_arrays():
    with pytest.raises(ValueError, match="uint8"):
        pprep.resize_lanczos(np.zeros((8, 8), np.float32), 4, 4)
    with pytest.raises(ValueError, match="uint8"):
        pprep.resize_lanczos(np.zeros((8, 8, 4), np.uint8), 4, 4)


def _mode_image(mode, seed=0, w=53, h=37):
    """A PIL image of ``mode`` with random pixels (random alpha too)."""
    rng = np.random.RandomState(seed)
    if mode == "L":
        return Image.fromarray(rng.randint(0, 256, (h, w)).astype(np.uint8))
    if mode in ("LA", "RGB", "RGBA"):
        c = {"LA": 2, "RGB": 3, "RGBA": 4}[mode]
        return Image.fromarray(
            rng.randint(0, 256, (h, w, c)).astype(np.uint8), mode)
    colours = 256 if mode == "P8" else 16
    rgb = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return rgb.quantize(colors=colours)


MODES = ["L", "LA", "RGB", "RGBA", "P8", "P4"]


@pytest.mark.parametrize("mode", MODES)
def test_read_png_rgb_equals_pillow_convert(mode, tmp_path):
    path = tmp_path / f"{mode}.png"
    _mode_image(mode).save(path, **({"bits": 4} if mode == "P4" else {}))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = read_png_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    # the JAX prep's conversion (a resize to the same size is a copy) and
    # its LANCZOS resize of the converted image
    assert np.array_equal(got, np.asarray(jprep.resize_image(path, (53, 37))))
    assert np.array_equal(pprep.resize_image(path, (32, 32)),
                          np.asarray(jprep.resize_image(path, (32, 32))))
    if mode.startswith("P"):         # read_png keeps returning the indices
        with Image.open(path) as im:
            assert np.array_equal(read_png(path), np.asarray(im))


def test_read_png_rgb_refuses_a_palette_image_without_plte(tmp_path):
    path = tmp_path / "p.png"
    _mode_image("P8").save(path)
    data = path.read_bytes()
    at = data.index(b"PLTE") - 4
    n = int.from_bytes(data[at:at + 4], "big")
    bad = tmp_path / "bad.png"
    bad.write_bytes(data[:at] + data[at + 12 + n:])
    with pytest.raises(ValueError, match="PLTE"):
        read_png_rgb(bad)


# --------------------------------------------------------------------------- #
# The prep tree against the JAX package's
# --------------------------------------------------------------------------- #

# one class with gray, RGB and RGBA sources of odd sizes, good test images
# and two defect dirs; a second with train images only
SOURCE = {"grid": {"train/good": ["L", "RGB", "RGBA", "L", "RGB", "L", "RGBA"],
                   "test/good": ["L", "RGB"],
                   "test/crack": ["RGBA", "L"],
                   "test/hole": ["RGB"]},
          "carpet": {"train/good": ["RGB", "RGB", "L"]}}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = tmp_path_factory.mktemp("src")
    seed = 0
    for classe, splits in SOURCE.items():
        for split, modes in splits.items():
            d = root / classe / split
            d.mkdir(parents=True)
            for i, mode in enumerate(modes):
                seed += 1
                _mode_image(mode, seed, w=90 + 7 * i, h=75 + 5 * i) \
                    .save(d / f"{i:03d}.png")
    return root


def _tree(root: Path) -> dict:
    """{relative path: decoded pixels} of every PNG under ``root``, decoded
    by PIL."""
    out = {}
    for p in sorted(root.rglob("*.png")):
        with Image.open(p) as im:
            out[str(p.relative_to(root))] = np.asarray(im)
    return out


def _assert_same_tree(got: Path, want: Path):
    a, b = _tree(got), _tree(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def _stale(target: Path):
    """A file from an earlier prep run in the target."""
    old = target / "old" / "train" / "good" / "HR"
    old.mkdir(parents=True)
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(old / "x.png")


@pytest.mark.parametrize("clean", [True, False], ids=["clean", "keep"])
@pytest.mark.parametrize("layout", ["mvtec", "gkd"])
def test_prepare_mvtec_dataset_equals_jax(source, tmp_path, layout, clean):
    kw = dict(classes=("grid", "carpet"), scale_factors=(2, 4, 8),
              target_hr=(64, 64), val_ratio=0.2, seed=7, clean=clean,
              layout=layout)
    for side in ("port", "jax"):
        _stale(tmp_path / side)
    pprep.prepare_mvtec_dataset(str(source), str(tmp_path / "port"), **kw)
    jprep.prepare_mvtec_dataset(str(source), str(tmp_path / "jax"), **kw)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "old").exists() is not clean
    names = {p.name for p in
             (tmp_path / "port" / "grid" / "test" / "bad" / "HR").iterdir()}
    assert names == {"crack_000.png", "crack_001.png", "hole_000.png"}
    hr = read_png(tmp_path / "port" / "grid" / "test" / "good" / "HR" /
                  "000.png")
    lr = read_png(tmp_path / "port" / "grid" / "test" / "good" / "LR_8" /
                  "000.png")
    assert hr.shape == (64, 64, 3) and lr.shape == (8, 8, 3)  # gray -> RGB
    args = dict(classes=("grid", "carpet", "none"), layout=layout,
                hr_size=64)
    got = pprep.verify_dataset_structure(str(tmp_path / "port"), **args)
    assert got == jprep.verify_dataset_structure(str(tmp_path / "jax"),
                                                 **args)
    train = "train/good" if layout == "mvtec" else "train/HR_64"
    assert got["grid"] == {train: 6, "val/good": 1, "test/good": 2,
                           "test/bad": 3}
    assert got["none"] == {train: 0, "val/good": 0, "test/good": 0,
                           "test/bad": 0}


@pytest.mark.parametrize("scales", [(), (2,), (4,), (8,), (4, 8), (8, 2, 4)])
def test_expand_scales_equals_jax(scales):
    assert pprep.expand_scales(scales) == jprep.expand_scales(scales)


@pytest.mark.parametrize("flags", [
    [],
    ["--hr-size", "32", "--scales", "4,8", "--layout", "gkd",
     "--val-ratio", "0.5", "--seed", "3"],
    ["--classes", "grid", "--no-clean"],
], ids=["defaults", "gkd-x8", "no-clean"])
def test_prepare_cli_equals_jax(source, tmp_path, capsys, flags):
    for side in ("port", "jax"):
        _stale(tmp_path / side)
    rcs, out = [], []
    for side, cli in (("port", pcli), ("jax", jcli)):
        target = str(tmp_path / side)
        rcs.append(cli.main(["--source", str(source), "--target", target]
                            + flags))
        out.append(capsys.readouterr().out.replace(target, "T"))
    assert rcs == [0, 0]
    assert out[0] == out[1] and "Dataset preparation complete!" in out[0]
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_prepare_cli_ignores_use_native(source, tmp_path, capsys):
    """``--use-native`` is accepted and changes nothing: the port's one
    resampler gives the JAX CLI's default (PIL) bytes."""
    assert pcli.main(["--source", str(source), "--target",
                      str(tmp_path / "port"), "--use-native"]) == 0
    assert jcli.main(["--source", str(source), "--target",
                      str(tmp_path / "jax")]) == 0
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_prepare_cli_reports_a_missing_source(tmp_path, capsys):
    missing = str(tmp_path / "nothing")
    assert pcli.main(["--source", missing]) == 1
    assert f"ERROR: Source data not found at {missing}" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        pcli.main(["--source", missing, "--scales", "3"])
