"""The port's PNG codec (``io/png.py``, numpy + zlib) against PIL: PIL-written
files of every supported kind decode to PIL's own array, rows with each of the
five filter types decode as PIL decodes them, and port-written files decode in
PIL to the array written."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from adsr_tpu_torch.data.pipeline import load_sr_dataset
from adsr_tpu_torch.io.png import SIGNATURE, read_png, write_png


def _smooth(h=37, w=45):
    yy, xx = np.mgrid[:h, :w]
    return ((np.sin(xx / 5.0) + np.cos(yy / 7.0)) * 60 + 128).astype(np.uint8)


def _images():
    g = _smooth()
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 256, g.shape, np.uint8)
    return {"L": g, "LA": np.stack([g, noise], -1),
            "RGB": np.stack([g, g[::-1], noise], -1),
            "RGBA": np.stack([g, noise, g[:, ::-1], 255 - g], -1)}


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_pil_written_files_decode_to_pils_array(tmp_path, mode, optimize):
    path = tmp_path / "a.png"
    Image.fromarray(_images()[mode]).save(path, optimize=optimize)
    with Image.open(path) as im:
        want = np.asarray(im)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("colors", [2, 4, 12, 200])
def test_palette_files_decode_to_indices(tmp_path, colors, optimize):
    # PIL writes 1-, 2-, 4- or 8-bit palettes by colour count; its array of a
    # palette image holds the indices
    path = tmp_path / "p.png"
    Image.fromarray(_smooth()).convert("P", palette=Image.ADAPTIVE,
                                       colors=colors).save(path,
                                                           optimize=optimize)
    with Image.open(path) as im:
        assert im.mode == "P"
        want = np.asarray(im)
    np.testing.assert_array_equal(read_png(path), want)


def _encode(img, ftypes, color, depth=8, palette=None):
    """A PNG whose row y is filtered with ftypes[y] (the filters applied as
    the PNG spec defines them), for the decoder's five reconstructions."""
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int32)
    ch = {0: 1, 2: 3, 3: 1, 6: 4}[color]
    bpp = max(1, ch * depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][ftypes[y]]
        out.append(bytes([ftypes[y]]) + ((x - pred) & 255)
                   .astype(np.uint8).tobytes())
        prev = x
    w = img.shape[1] if depth == 8 else img.shape[1] * 8 // depth

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette)
    return data + chunk(b"IDAT", zlib.compress(b"".join(out))) \
        + chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette4"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_every_filter_type_decodes_as_pil_decodes_it(tmp_path, kind, ftype):
    rng = np.random.RandomState(1)
    h = 23
    types = (rng.randint(0, 5, h) if ftype == "mixed"
             else np.full(h, ftype)).tolist()
    if kind == "palette4":                 # two 4-bit indices a byte
        idx = rng.randint(0, 16, (h, 30)).astype(np.uint8)
        packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
        data = _encode(packed, types, 3, 4,
                       bytes(rng.randint(0, 256, 48, np.uint8)))
    else:
        img = {"gray": _smooth(h, 31), "rgb": _images()["RGB"][:h],
               "rgba": _images()["RGBA"][:h]}[kind]
        data = _encode(img, types, {"gray": 0, "rgb": 2, "rgba": 6}[kind])
    path = tmp_path / "f.png"
    path.write_bytes(data)
    with Image.open(path) as im:
        want = np.asarray(im)
    np.testing.assert_array_equal(read_png(path), want)
    if kind == "palette4":
        np.testing.assert_array_equal(want, idx)


@pytest.mark.parametrize("shape", [(19, 23), (19, 23, 1), (19, 23, 3)])
def test_port_written_files_decode_in_pil(tmp_path, shape):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, shape, np.uint8)
    path = tmp_path / "w.png"
    write_png(path, img)
    with Image.open(path) as im:
        got = np.asarray(im)
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    np.testing.assert_array_equal(read_png(path), got)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    sixteen = tmp_path / "sixteen.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000) \
        .save(sixteen)
    with pytest.raises(ValueError, match="sixteen.png"):
        read_png(sixteen)
    good = tmp_path / "good.png"
    write_png(good, _smooth())
    data = bytearray(good.read_bytes())
    ihdr = 8 + 8                         # interlace is the IHDR's last byte
    data[ihdr + 12] = 1
    data[ihdr + 13:ihdr + 17] = struct.pack(
        ">I", zlib.crc32(bytes(data[ihdr - 4:ihdr + 13])) & 0xFFFFFFFF)
    laced = tmp_path / "laced.png"
    laced.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="laced.png.*interlaced"):
        read_png(laced)
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", np.zeros((4, 4, 4), np.uint8))


def test_dataset_loads_through_the_port_codec(tmp_path):
    # the loader reads PIL-written MVTec-style files with io/png.py
    base = tmp_path / "split"
    (base / "HR").mkdir(parents=True)
    (base / "LR_bicubic" / "X2").mkdir(parents=True)
    rgb = _images()["RGB"][:16, :16]
    Image.fromarray(rgb).save(base / "HR" / "000.png")
    Image.fromarray(rgb[::2, ::2]).save(base / "LR_bicubic" / "X2" /
                                        "000x2.png")
    ds = load_sr_dataset(str(base), (2,), n_colors=3)
    np.testing.assert_array_equal(ds.hr[0], rgb.astype(np.float32))
    np.testing.assert_array_equal(ds.lrs[0][0], rgb[::2, ::2].astype(np.float32))
