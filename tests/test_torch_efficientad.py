"""The port's EfficientAD networks and data on the CPU against the JAX
package and Pillow: the PDNs and the autoencoder on weights carried across
(``io/convert.py``), the decoder's resizes against ``jax.image.resize``, the
converters both ways, ``resize_bilinear`` byte for byte against
``Image.BILINEAR``, the loaders, the hard quantile against ``jnp.quantile``
(past 2^24 elements too), the jitter and grayscale on ``jax.random``'s own
draws, and the early stopping and threshold metrics (f32, inputs from numpy
seeds)."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from adsr_tpu.io.torch_convert import convert_autoencoder, convert_pdn
from adsr_tpu.models.efficientad import Autoencoder as JaxAutoencoder
from adsr_tpu.models.efficientad import PDN as JaxPDN
from adsr_tpu.train import efficientad as jead

from adsr_tpu_torch.data.prepare import resize_bilinear
from adsr_tpu_torch.io.convert import (autoencoder_state_dict_from_jax,
                                       pdn_state_dict_from_jax)
from adsr_tpu_torch.io.png import write_png
from adsr_tpu_torch.models.efficientad import (PDN, Autoencoder, Resize,
                                               init_efficientad_)
from adsr_tpu_torch.train import efficientad as pead

FWD_RTOL = 1e-5          # f32 forward, relative to the output's max


def perturbed(params, seed):
    """Every leaf plus a seeded N(0, 0.02), so biases are not zero and the
    autoencoder's outputs are not vanishing."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.02 * rng.randn(*np.shape(a)).astype(np.float32)),
        params)


def jax_pdn(out_channels, size, padding=False, hw=64, seed=0):
    module = JaxPDN(out_channels, size, padding)
    x = jnp.zeros((1, hw, hw, 3))
    return module, perturbed(module.init(jax.random.key(seed), x)["params"],
                             seed)


def jax_autoencoder(out_channels, seed=0):
    module = JaxAutoencoder(out_channels)
    x = jnp.zeros((1, 256, 256, 3))
    return module, perturbed(module.init(jax.random.key(seed), x)["params"],
                             seed)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def assert_close(got, want, rtol=FWD_RTOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


# --------------------------------------------------------------------------- #
# Networks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("padding", [False, True], ids=["valid", "padded"])
@pytest.mark.parametrize("size", ["small", "medium"])
def test_pdn_matches_jax(size, padding):
    module, params = jax_pdn(24, size, padding)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, x))
    model = PDN(24, size, padding)
    model.load_state_dict(pdn_state_dict_from_jax(params, size))
    with torch.no_grad():
        got = nhwc(model(nchw(x)))
    assert_close(got, want)


def test_autoencoder_matches_jax():
    """256 px in, 56 x 56 out, through the antialiased 127 -> 56 resize."""
    module, params = jax_autoencoder(16)
    x = np.random.RandomState(2).randn(2, 256, 256, 3).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, x,
                                   deterministic=True))
    model = Autoencoder(16).eval()
    model.load_state_dict(autoencoder_state_dict_from_jax(params))
    with torch.no_grad():
        got = nhwc(model(nchw(x)))
    assert want.shape == (2, 56, 56, 16)
    assert_close(got, want)


RESIZES = [(1, 3), (3, 8), (8, 15), (15, 32), (32, 63), (63, 127), (127, 56)]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a}-{b}" for a, b in
                                                  RESIZES])
def test_decoder_resize_matches_jax_image_resize(src, dst):
    """Each step of the decoder's ladder on N(0, 1) inputs: within 1e-5
    (torch's f32 source coordinate (x + 0.5) * in / out - 0.5 carries a
    rounding error that grows with x: up to 3.8e-6 seen at 32 -> 63; at
    127 -> 56 a resize without antialiasing is 2.65 off)."""
    x = np.random.RandomState(src).randn(2, src, src, 5).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, dst, dst, 5), "bilinear"))
    got = nhwc(Resize(dst)(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    stack = [m for m in Autoencoder(4) if isinstance(m, Resize)]
    assert [m.size for m in stack] == [3, 8, 15, 32, 63, 127, 56]


@pytest.mark.parametrize("net", ["small", "medium", "autoencoder"])
def test_converters_round_trip(net):
    """The port's state_dict maps into the JAX tree through the JAX
    package's converter with no unmapped key and back unchanged; the JAX
    tree maps into the port's state_dict with every key of the module."""
    if net == "autoencoder":
        _, params = jax_autoencoder(8)
        model = init_efficientad_(Autoencoder(8),
                                  torch.Generator().manual_seed(0))
        to_port = autoencoder_state_dict_from_jax
        to_jax = convert_autoencoder
    else:
        _, params = jax_pdn(8, net)
        model = init_efficientad_(PDN(8, net),
                                  torch.Generator().manual_seed(0))
        to_port = lambda p: pdn_state_dict_from_jax(p, net)  # noqa: E731
        to_jax = lambda sd: convert_pdn(sd, size=net)  # noqa: E731
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = to_port(to_jax(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    carried = to_port(params)
    assert set(carried) == set(model.state_dict())
    model.load_state_dict(carried)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           to_jax({k: v.numpy() for k, v in carried.items()}),
                           params)


def test_converters_refuse_unknown_names():
    with pytest.raises(KeyError, match="unmapped"):
        pdn_state_dict_from_jax({"conv9": {"kernel": np.zeros((1, 1, 1, 1))}})
    with pytest.raises(KeyError, match="unmapped"):
        autoencoder_state_dict_from_jax({"enc9": {"bias": np.zeros(2)}})


def test_init_is_torch_default_with_zero_bias():
    model = init_efficientad_(PDN(8, "small"), torch.Generator().manual_seed(3))
    conv = model[3]
    bound = 1.0 / np.sqrt(128 * 4 * 4)
    w = conv.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert not conv.bias.detach().numpy().any()


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #

BILINEAR_SIZES = [((256, 256), (256, 256)), ((300, 200), (256, 256)),
                  ((64, 64), (256, 256)), ((900, 700), (512, 512)),
                  ((1024, 1024), (256, 256)), ((33, 17), (40, 70))]


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("src,dst", BILINEAR_SIZES, ids=[
    f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in BILINEAR_SIZES])
def test_resize_bilinear_is_pillow_exact(src, dst, channels):
    rng = np.random.RandomState(src[0] + dst[1])
    shape = (src[1], src[0]) + (() if channels == 1 else (3,))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR))
    got = resize_bilinear(img, *dst)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _tree(root, seed=0, size=80):
    """root/{good,crack}/NNN_x.png: RGB and gray PNGs written by the port."""
    rng = np.random.RandomState(seed)
    for sub, n in (("good", 3), ("crack", 2)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            shape = (size, size + 7, 3) if i % 2 else (size, size + 7)
            write_png(root / sub / f"{i:03d}_x.png",
                      rng.randint(0, 256, shape).astype(np.uint8))


def test_load_image_folder_matches_jax(tmp_path):
    _tree(tmp_path)
    got = pead.load_image_folder(str(tmp_path), 64)
    want = jead.load_image_folder(str(tmp_path), 64)
    assert got[0].dtype == np.float32 and got[0].shape == (5, 64, 64, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_load_penalty_folder_matches_jax(tmp_path):
    _tree(tmp_path, seed=1)
    for cap in (0, 3):
        got = pead.load_penalty_folder(str(tmp_path), 32, max_images=cap,
                                       seed=4)
        want = jead.load_penalty_folder(str(tmp_path), 32, max_images=cap,
                                        seed=4)
        assert got.shape == (len(want), 32, 32, 3)
        np.testing.assert_array_equal(got, want)


def test_loaders_refuse_non_png_by_name(tmp_path):
    _tree(tmp_path)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "good" / "zzz.jpg")
    with pytest.raises(ValueError, match="zzz.jpg"):
        pead.load_image_folder(str(tmp_path), 32)
    with pytest.raises(FileNotFoundError):
        pead.load_image_folder(str(tmp_path / "none"), 32)


def test_normalize_imagenet():
    x = torch.full((1, 2, 2, 3), 0.5)
    got = pead.normalize_imagenet(x).numpy()
    want = np.asarray(jead.normalize_imagenet(jnp.full((1, 2, 2, 3), 0.5)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# The hard quantile, the jitter, the stopping rule and the metrics
# --------------------------------------------------------------------------- #

def _quantile_input(kind):
    rng = np.random.RandomState(5)
    if kind == "normal":
        return rng.randn(2, 56, 56, 8).astype(np.float32) ** 2
    if kind == "ties":
        return rng.randint(0, 5, (3, 56, 56, 8)).astype(np.float32)
    # past 2^24 elements (torch.quantile's limit): zeros and a tail of
    # distinct values that the 0.999 quantile falls inside
    n = 2 ** 24 + 2 ** 21
    x = np.zeros(n, np.float32)
    tail = 4 * n // 1000
    x[rng.choice(n, tail, replace=False)] = rng.rand(tail).astype(
        np.float32) + 1.0
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "past_2_24"])
def test_hard_quantile_matches_jnp_quantile(kind):
    x = _quantile_input(kind)
    want = float(jnp.quantile(jnp.asarray(x).reshape(-1),
                              pead.HARD_QUANTILE))
    got = pead.hard_quantile(torch.from_numpy(x))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if kind == "past_2_24":
        assert x.size > 2 ** 24 and want > 1.0


def _jax_jitter_draws(key, b):
    kc, kf = jax.random.split(key)
    return (np.array(jax.random.randint(kc, (b,), 0, 3)),
            np.array(jax.random.uniform(kf, (b,), minval=0.8, maxval=1.2)))


def test_color_jitter_on_jax_draws():
    """All three branches, on the draws ``color_jitter_ae`` makes: within
    1e-6 of it."""
    x = np.random.RandomState(6).rand(16, 12, 12, 3).astype(np.float32)
    key = jax.random.key(3)
    choice, factor = _jax_jitter_draws(key, 16)
    assert set(choice.tolist()) == {0, 1, 2}
    want = np.asarray(jead.color_jitter_ae(jnp.asarray(x), key))
    got = pead.color_jitter(torch.from_numpy(x), torch.from_numpy(choice),
                            torch.from_numpy(factor)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_random_grayscale_on_jax_draws():
    x = np.random.RandomState(7).rand(32, 8, 8, 3).astype(np.float32)
    key = jax.random.key(9)
    pick = np.array(jax.random.bernoulli(key, 0.3, (32, 1, 1, 1))).ravel()
    assert 0 < pick.sum() < 32
    want = np.asarray(jead.random_grayscale(jnp.asarray(x), key))
    got = pead.random_grayscale(torch.from_numpy(x),
                                torch.from_numpy(pick)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_step_draws_distribution():
    """The draws' ranges and rates, as ``jax.random``'s (compared in
    distribution, not bit for bit)."""
    d = pead.StepDraws.sample(20000, torch.Generator().manual_seed(0),
                              penalty=True)
    counts = np.bincount(d.choice.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(counts, 1 / 3, atol=0.02)
    f = d.factor.numpy()
    assert f.dtype == np.float32 and f.min() >= 0.8 and f.max() < 1.2
    assert abs(f.mean() - 1.0) < 0.01
    assert abs(d.pick.numpy().mean() - 0.3) < 0.02
    assert pead.StepDraws.sample(4, torch.Generator()).pick is None


class TestEarlyStopping:
    """The JAX suite's cases (tests/test_efficientad.py)."""

    def test_plateau_stops(self):
        s = pead.EarlyStopping(patience=3, min_delta=0.01, best_auc=0.98)
        assert not s.should_stop(0.99)
        assert not s.should_stop(0.975)
        assert s.should_stop(0.99)  # third consecutive >= 0.97

    def test_low_auc_resets(self):
        s = pead.EarlyStopping(patience=2, min_delta=0.01, best_auc=0.98)
        assert not s.should_stop(0.99)
        assert not s.should_stop(0.5)   # reset
        assert not s.should_stop(0.99)
        assert s.should_stop(0.99)


def test_final_metrics_perfect_classifier():
    fm = pead.final_metrics([0, 0, 1, 1], [0.1, 0.2, 0.8, 0.9])
    assert fm["accuracy"] == 1.0
    assert fm["precision"] == 1.0 and fm["recall"] == 1.0
    assert fm["f1"] == pytest.approx(1.0)


def test_final_metrics_match_jax():
    rng = np.random.RandomState(8)
    y = rng.randint(0, 2, 40).tolist()
    s = (rng.rand(40) + 0.4 * np.asarray(y)).tolist()
    assert pead.final_metrics(y, s) == jead.final_metrics(y, s)
