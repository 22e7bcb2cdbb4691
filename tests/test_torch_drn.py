"""The port's DRN-L (``adsr_tpu_torch/models/drn.py``, ``models/common.py``)
against the JAX package on the CPU: every building block, the bicubic
upsample, the whole multi-scale forward at one, two and three scales in
gray and RGB, the config, the seeded init, and the weight carry both ways
(``drn_state_dict_from_jax`` / ``convert_drn`` + ``stack_drn_rcabs``). The
same numpy inputs go through both; f32, tiny widths."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.core import config as jc
from adsr_tpu.io.torch_convert import convert_drn, stack_drn_rcabs
from adsr_tpu.models import common as jcommon
from adsr_tpu.models import drn as jdrn
from adsr_tpu.models.factory import make_model as jax_make_model

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.io.convert import drn_duals_from_jax, drn_state_dict_from_jax
from adsr_tpu_torch.models import common as pcommon
from adsr_tpu_torch.models import drn as pdrn
from adsr_tpu_torch.models.factory import init_sr_params, make_model

from torch_port_util import ATOL, RTOL, drn_jax_params

RGB_RANGE = 255.0


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _carry(tree, names):
    """A JAX block's param tree -> a torch state_dict, the conv scope named
    through ``names`` (a dict or a function of the scope)."""
    out = {}
    for path, v in _flat(tree):
        scope, leaf = path.rsplit("/", 1)
        name = names(scope) if callable(names) else names[scope]
        arr = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v
        out[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = \
            torch.from_numpy(np.array(arr, np.float32))
    return out


def _perturbed(params, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.randn(*np.shape(a)).astype(np.float32), params)


RCAB_NAMES = {"conv0": "body.0", "conv1": "body.2",
              "ca/du_reduce": "body.3.conv_du.0",
              "ca/du_expand": "body.3.conv_du.2"}

# (JAX module, port module, torch name of each JAX conv scope, channels in)
BLOCKS = {
    "MeanShift": (lambda: jcommon.MeanShift(3, RGB_RANGE, jcommon.RGB_MEAN,
                                            sign=-1),
                  lambda: pcommon.MeanShift(3, RGB_RANGE, pcommon.RGB_MEAN,
                                            sign=-1),
                  lambda s: "", 3),
    "CALayer": (lambda: jcommon.CALayer(32), lambda: pcommon.CALayer(32),
                {"du_reduce": "conv_du.0", "du_expand": "conv_du.2"}, 32),
    # 8 channels: the reduced width is max(1, 8 // 16) = 1
    "CALayer8": (lambda: jcommon.CALayer(8), lambda: pcommon.CALayer(8),
                 {"du_reduce": "conv_du.0", "du_expand": "conv_du.2"}, 8),
    "RCAB": (lambda: jcommon.RCAB(16), lambda: pcommon.RCAB(16), RCAB_NAMES,
             16),
    "Upsampler": (lambda: jcommon.Upsampler(4, 6),
                  lambda: pcommon.Upsampler(4, 6),
                  lambda s: str(2 * int(s[len("conv"):])), 6),
    "DownBlock": (lambda: jdrn.DownBlock(scale=4, n_feat=8, in_channels=3,
                                         out_channels=5),
                  lambda: pdrn.DownBlock(4, 8, 3, 5),
                  lambda s: ("dual_module.2" if s == "proj"
                             else f"dual_module.{int(s[4:])}.0"), 3),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port, names, c = BLOCKS[name]
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 12, 12, c) * 20).astype(np.float32)
    blk = make_jax()
    params = _perturbed(blk.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    mod = make_port()
    sd = _carry(params, names)
    if name == "MeanShift":
        sd = {k.lstrip("."): v for k, v in sd.items()}
    mod.load_state_dict(sd)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_mean_shift_initialises_to_the_reference_quirk():
    sd = pcommon.MeanShift(3, RGB_RANGE, pcommon.RGB_MEAN, sign=1).state_dict()
    np.testing.assert_array_equal(sd["weight"][:, :, 0, 0], np.eye(3))
    np.testing.assert_allclose(sd["bias"],
                               RGB_RANGE * np.asarray(pcommon.RGB_MEAN))
    assert pcommon.GRAY_MEAN == jcommon.GRAY_MEAN
    assert pcommon.RGB_MEAN == jcommon.RGB_MEAN


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_bicubic_matches_jax(factor):
    """Sizes 1-17 at each factor: the matrix equals the JAX one, and the
    upsample of a random image too (borders included)."""
    rng = np.random.RandomState(factor)
    for n in range(1, 18):
        np.testing.assert_allclose(pcommon.bicubic_matrix(n, factor).numpy(),
                                   jcommon._bicubic_matrix(n, factor),
                                   rtol=0, atol=1e-7)
        x = (rng.rand(2, n, n + 1, 3) * 255).astype(np.float32)
        want = np.asarray(jcommon.upsample_bicubic(jnp.asarray(x), factor))
        got = pcommon.upsample_bicubic(
            torch.from_numpy(x).permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-6)


@pytest.mark.parametrize("scale", [(2,), (2, 4), (2, 4, 8)])
@pytest.mark.parametrize("n_colors", [1, 3])
def test_drn_matches_jax(scale, n_colors):
    jcfg, pcfg, params, _ = drn_jax_params(scale, n_colors)
    lr_px = 32 // max(scale)
    x = (np.random.RandomState(2).rand(2, lr_px, lr_px, n_colors)
         * RGB_RANGE).astype(np.float32)
    want = jax.jit(jax_make_model(jcfg).apply)({"params": params},
                                               jnp.asarray(x))
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(drn_state_dict_from_jax(params, pcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == len(scale) + 1
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, lr_px * 2 ** p, lr_px * 2 ** p, n_colors)
        np.testing.assert_allclose(g.numpy() / RGB_RANGE,
                                   np.asarray(w) / RGB_RANGE, atol=ATOL,
                                   rtol=RTOL)


def test_drn_bf16_matches_the_jax_bf16_module():
    """bf16 means the JAX ``dtype=bf16`` module: the SRs agree to two bf16
    steps of the [0, 1] scale."""
    jcfg, pcfg, params, _ = drn_jax_params((2, 4), 3)
    x = (np.random.RandomState(3).rand(2, 8, 8, 3) * RGB_RANGE
         ).astype(np.float32)
    want = jax.jit(jax_make_model(jcfg, "bf16").apply)({"params": params},
                                                        jnp.asarray(x))
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(drn_state_dict_from_jax(params, pcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x), dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy() / RGB_RANGE,
                                   np.asarray(w, np.float32) / RGB_RANGE,
                                   atol=2 ** -7, rtol=0)


@pytest.mark.parametrize("scan_blocks", [True, False])
def test_state_dict_maps_into_the_jax_tree_and_back(scan_blocks):
    """``convert_drn`` of the port's state_dict (then ``stack_drn_rcabs``
    for the scanned tree) has the JAX init tree's keys and shapes, no key
    unmapped; ``drn_state_dict_from_jax`` takes it back exactly."""
    _, pcfg, params, _ = drn_jax_params((2, 4), 1, scan_blocks=True)
    sd, _ = init_sr_params(pcfg, torch.Generator().manual_seed(3),
                           device="cpu")
    tree = convert_drn({k: v.numpy() for k, v in sd.items()}, phase=2,
                       n_blocks=pcfg.n_blocks)
    if scan_blocks:
        tree = stack_drn_rcabs(tree, phase=2, n_blocks=pcfg.n_blocks)
    if not scan_blocks:
        params = drn_jax_params((2, 4), 1, scan_blocks=False)[2]
    want = dict(_flat(params))
    got = dict(_flat(tree))
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in want)
    back = drn_state_dict_from_jax(tree, pcfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_duals_carry_and_run_as_the_jax_duals():
    jcfg, pcfg, _, duals = drn_jax_params((2, 4), 3)
    sds = drn_duals_from_jax(duals, pcfg)
    mods = pdrn.make_dual_models(pcfg)
    assert len(sds) == len(mods) == 2
    x = (np.random.RandomState(4).rand(2, 16, 16, 3) * RGB_RANGE
         ).astype(np.float32)
    for jmod, params, mod, sd in zip(jdrn.make_dual_models(jcfg), duals,
                                     mods, sds):
        assert set(sd) == {"dual_module.0.0.weight", "dual_module.1.weight"}
        mod.load_state_dict(sd)
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = pdrn.apply_dual(mod, torch.from_numpy(x))
        assert got.shape == (2, 8, 8, 3)
        np.testing.assert_allclose(got.numpy() / RGB_RANGE,
                                   want / RGB_RANGE, atol=ATOL, rtol=RTOL)


def test_init_sr_params_at_full_width():
    """DRN-L x4 (40 RCABs an up phase at 20 features): 9.82M parameters,
    720 in the two duals; the carpet twin 9.83M; torch's conv uniform,
    zero biases, MeanShift's identity and mean bias."""
    exp = pc.drn_experiment("grid", 128, 4, run_tag="t")
    sd, duals = init_sr_params(exp.model, torch.Generator().manual_seed(0),
                               device="cpu")
    assert sum(v.numel() for v in sd.values()) == 9_821_907
    assert sum(v.numel() for d in duals for v in d.values()) == 720
    rgb = pc.drn_experiment("carpet", 128, 4, run_tag="t").model
    assert sum(v.numel() for v in make_model(rgb, "cpu").state_dict()
               .values()) == 9_825_893
    w = sd["up_blocks.1.39.body.2.weight"]
    bound = 1.0 / np.sqrt(w[0].numel())
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound
    assert not sd["up_blocks.1.39.body.2.bias"].any()
    np.testing.assert_array_equal(sd["sub_mean.weight"].flatten(), [1.0])
    np.testing.assert_allclose(sd["sub_mean.bias"],
                               [-RGB_RANGE * pcommon.GRAY_MEAN[0]])
    again, _ = init_sr_params(exp.model, torch.Generator().manual_seed(0),
                              device="cpu")
    assert all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("classe,resolution,scale,precision", [
    ("grid", 128, 4, "bf16"), ("carpet", 512, 8, "fp32"),
    ("grid", 64, 2, "bf16")])
def test_drn_experiment_equal(classe, resolution, scale, precision):
    ours = pc.drn_experiment(classe, resolution, scale, precision=precision,
                             run_tag="tag")
    theirs = jc.drn_experiment(classe, resolution, scale,
                               precision=precision, run_tag="tag")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_flat_dict() == theirs.to_flat_dict()
    assert ours.model.max_scale == theirs.model.max_scale == scale
    assert pc.progressive_scales(scale) == jc.progressive_scales(scale)
    assert re.search(r"/drn-l/mvtec_\w+_\d+_X\dtag/$", ours.save)
