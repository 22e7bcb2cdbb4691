"""fp32 DRCT training: the port's f32 gradients against ``jax.value_and_grad``
through the JAX fused training forward at dtype f32 (its Pallas backward
kernel in interpret mode), the launch plans of the f32 backward kernels
(d) and (f) at the flagship, 256px/x4 and 64/x4 widths (on tensor
metadata: no card needed), the layout rule of (d)'s f32 instance, and the
route rule: fp32 trains on the card at any mesh, and without a card
``cli.main --device cuda`` fails on the device before any data is read."""

import os

os.environ["ADSR_TPU_PALLAS_INTERPRET"] = "1"

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.ops import fused_rdg_train as jfrt

from adsr_tpu_torch.cli import main as cli_main
from adsr_tpu_torch.core.config import MeshConfig, drct_experiment
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.kernels import fused_rdg_train as frt
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
from adsr_tpu_torch.kernels import window_attention_bwd as ab
from adsr_tpu_torch.kernels.fused_rdg import rdg_geometry
from adsr_tpu_torch.kernels.rdg_gemm import pitched
from adsr_tpu_torch.kernels.window_attention import (BLOCK_SHARED_MAX,
                                                     head_tile)
from adsr_tpu_torch.models.factory import make_model
from adsr_tpu_torch.train.trainer import (check_serving_precision,
                                          check_training_precision)

from torch_port_util import jax_params, lr_input, port_state_dict

# the three geometries fp32 trains at on the card: (resolution, scale) ->
# LR side, window; batch 16
GEOMETRIES = {"flagship": (128, 4), "256px_x4": (256, 4), "64_x4": (64, 4)}
BATCH = 16


def _cfg(geo):
    return drct_experiment("grid", *GEOMETRIES[geo], run_tag="t",
                           precision="fp32").model


def test_fp32_train_grads_match_jax_fused_train_bwd(monkeypatch):
    """The JAX suite's gradient test (tests/test_fused_rdg_train.py:46-83)
    against the port: loss and every parameter's gradient of the L1 loss
    through the fused training forward at f32, the JAX one's backward its
    Pallas kernel (TPU kernel 3) in interpret mode, the port's every
    kernel wrapper on its plain f32 version; the JAX suite's scale-relative
    tolerance."""
    monkeypatch.setattr(jfrt, "_INTERPRET", True)
    jcfg, pcfg, params = jax_params("train1")
    x = lr_input(jcfg)
    side = jcfg.img_size * jcfg.upscale
    hr = (np.random.RandomState(1).rand(x.shape[0], side, side,
                                        jcfg.in_chans) * 255
          ).astype(np.float32)

    def loss(p):
        sr = jfrt.fused_drct_train_forward(p, jcfg, jnp.asarray(x),
                                           deterministic=True,
                                           dtype=jnp.float32)
        return jnp.mean(jnp.abs(sr - hr))

    jl, jg = jax.value_and_grad(loss)(params)
    want = drct_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                                    pcfg)
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(port_state_dict("train1"))
    named = dict(model.named_parameters())
    dp = torch.ones(pcfg.num_layers, x.shape[0], 10)
    sr = frt.fused_drct_train_forward(named, pcfg, torch.from_numpy(x), dp,
                                      dtype=torch.float32)
    pl = (sr - torch.from_numpy(hr)).abs().mean()
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-4)
    assert set(named) == set(want)
    for k, p in named.items():
        a, b = want[k].numpy(), p.grad.numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=2e-3 * scale, rtol=2e-2,
                                   err_msg=k)


def _products(cfg, k):
    """Block k's five backward products as (name, N, K) of dY [M, N] and W
    [N, K], as the training backward calls ``rdg_gemm_grads``."""
    g = rdg_geometry(cfg)
    c, f, a = g["feats"][k], g["hidden"][k], g["adj_out"][k]
    return [("adjust", a, c), ("fc2", c, f), ("fc1", f, c), ("proj", c, c),
            ("qkv", 3 * c, c)]


def _covered_once(total, step, count):
    """Each of ``total`` items in exactly one of ``count`` runs of ``step``."""
    hits = np.zeros(total, np.int64)
    for i in range(count):
        hits[i * step:min(total, (i + 1) * step)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_gemm_bwd_f32_plan_covers_every_product(geo, k):
    cfg = _cfg(geo)
    m = BATCH * cfg.img_size ** 2
    for name, n, kk in _products(cfg, k):
        for prep in (False, True):
            p = gb.gemm_bwd_f32_plan(m, n, kk, 132, True, True, prep)
            # dgrad's and wgrad's rings: min_blocks of each fit an SM
            for smem, per_sm in zip(p["smem_bytes"], p["min_blocks"]):
                assert per_sm * (smem + 1024) <= 233472, name
                assert smem <= BLOCK_SHARED_MAX, name
            (dm, dn), (bm, bn) = p["dgrad_tile"], p["wgrad_tile"]
            assert p["prep_grid"][0] * 32 >= n and p["prep_grid"][1] * 32 >= m
            dg, wg = p["dgrad_grid"], p["wgrad_grid"]
            assert dg[0] * dn >= kk and dg[1] * dm >= m and dg[1] <= 65535
            assert wg[0] * bn >= kk and wg[1] * bm >= n
            assert wg[2] == p["splits"] <= 65535
            rows = p["rows_per_split"]
            assert rows % gb.F32_BK == 0 and (rows >= 256 or p["splits"] == 1)
            assert _covered_once(m, rows, p["splits"]), (name, rows)
            # scratch regions in order, disjoint, 256-byte aligned: dY_eff
            # (read K-major by dgrad, so no transpose), the partials
            ends = [(0, m * n * 4 if prep else 0),
                    (p["part"], p["splits"] * n * kk * 4),
                    (p["db_part"], -(-m // 32) * n * 4)]
            assert "eff_t" not in p
            for (start, size), (nxt, _) in zip(ends, ends[1:]):
                assert start % 256 == 0 and start + size <= nxt
            assert ends[-1][0] + ends[-1][1] == p["bytes"]
            assert p["flops"] == 4 * m * n * kk


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_attention_bwd_f32_plan_covers_every_window_and_head(geo, k):
    cfg = _cfg(geo)
    g = rdg_geometry(cfg)
    c, nh, win = g["feats"][k], g["heads"][k], cfg.window_size
    side = cfg.img_size
    p = ab.window_attention_bwd_f32_plan(c, nh, BATCH, side, side, win, 132)
    n = win * win
    # head dims pad to 16 at N = 16 and 64 (the n8 tiles of a warp pair's
    # halves), to 8 at N = 256 (the tensor cores' k8 steps and n8 tiles)
    hdp = -(-(c // nh) // 8) * 8 if n == 256 else head_tile(c // nh)
    assert p["hdp"] == hdp and p["pitch"] == hdp + 4
    rows = 64
    assert p["rows"] == rows
    # the source's layout (csrc/window_attention_bwd_f32.cuh
    # bwd_smem_bytes, dq16_smem_bytes, dkv16_smem_bytes)
    plane = rows * (hdp + 4) * 4
    assert p["blocks_per_sm"] >= 1
    windows = BATCH * (side // win) ** 2
    assert p["windows"] == windows
    assert _covered_once(windows, p["group"], p["groups"])
    assert 1 <= p["last_group"] <= p["group"]
    assert p["partial_bytes"] == p["groups"] * nh * n * n * 4
    if n == 256:
        # the warps' exchange: [2 writers][4 row warps][4 n8 tiles][32
        # lanes] float4s; each row's max, 1 / sum and D
        assert ab.EXCHANGE_BYTES == 2 * 4 * 4 * 32 * 16
        assert ab.STAT_BYTES == 3 * 64 * 4
        # dq: q, dO and two k and two v planes (the next key tile lands
        # while one is computed)
        assert p["smem_dq_bytes"] == 6 * plane + ab.EXCHANGE_BYTES \
            + ab.STAT_BYTES <= BLOCK_SHARED_MAX
        # dkv: k, v, one or two q and dO buffers with their statistics, and
        # its keys' d(bias) columns [256][64 + 4]; two where they fit
        assert ab.DB_PITCH == 68
        nb = p["dkv_buffers"]
        assert p["smem_bytes"] == (2 + 2 * nb) * plane + ab.EXCHANGE_BYTES \
            + nb * ab.STAT_BYTES + 4 * 256 * 68 <= BLOCK_SHARED_MAX
        two = 6 * plane + ab.EXCHANGE_BYTES + 2 * ab.STAT_BYTES \
            + 4 * 256 * 68
        assert nb == (2 if two <= BLOCK_SHARED_MAX else 1)
        assert p["partial_bytes"] <= ab.MAX_PARTIAL_BYTES
        assert p["launches"] == 2
        assert p["blocks"] == p["groups"] * nh * 4
        assert p["dq_blocks"] == windows * nh * 4
        assert p["dsum_bytes"] == windows * nh * n * 4
    else:
        # one or two sets of the q, k, v and dO planes [64][hdp + 4] (two
        # where they fit: the next set lands while one is computed), the P
        # and dS tiles [64][N + 4] and the rows' halves of max, sum and D
        tiles = 2 * rows * (n + 4) * 4 + 3 * 2 * rows * 4
        nb = p["buffers"]
        assert nb == (2 if 8 * plane + tiles <= BLOCK_SHARED_MAX else 1)
        assert p["smem_bytes"] == 4 * nb * plane + tiles <= BLOCK_SHARED_MAX
        assert p["tile_pitch"] == n + 4 and p["set_windows"] == rows // n
        assert p["launches"] == 1 and p["blocks"] == p["groups"] * nh
        # a group is whole sets of windows, at most MAX_GROUP sets
        assert p["group"] % p["set_windows"] == 0
        assert p["group"] <= ab.MAX_GROUP * p["set_windows"]
        assert p["blocks_per_sm"] <= p["min_blocks"] == \
            (2 if hdp <= 48 else 1)


@pytest.mark.parametrize("hd", [1, 7, 8, 9, 30, 46, 53, 77, 122, 127, 128])
def test_attention_bwd16_f32_plan_pads_head_dims_to_8_and_fits(hd):
    # every head dim the N = 256 kernel takes (hd <= 128): the least
    # multiple of 8 (the mma k8 steps and n8 tiles; at the flagship 30, 53,
    # 122, 46 and 77 -> 32, 56, 128, 48 and 80), both launches within 227
    # KB of dynamic shared memory, blocks an SM by the sources' launch bounds
    p = ab.window_attention_bwd_f32_plan(2 * hd, 2, 1, 16, 16, 16, 132)
    hdp = p["hdp"]
    assert hdp % 8 == 0 and hd <= hdp < hd + 8
    assert p["smem_bytes"] <= BLOCK_SHARED_MAX
    assert p["smem_dq_bytes"] <= BLOCK_SHARED_MAX
    dq_most, dkv_most = ab.bwd16_f32_min_blocks(hdp)
    assert 1 <= p["dq_blocks_per_sm"] <= dq_most
    assert 1 <= p["blocks_per_sm"] <= dkv_most


@pytest.mark.parametrize("mesh", [MeshConfig(), MeshConfig(dp=2),
                                  MeshConfig(tp=2), MeshConfig(dp=2, tp=2)],
                         ids=["one", "dp2", "tp2", "dp2xtp2"])
def test_check_training_precision_accepts_fp32_on_cuda(mesh):
    exp = drct_experiment("grid", 128, 4, run_tag="t", precision="fp32",
                          mesh=mesh)
    check_training_precision(exp, torch.device("cuda"))
    # fp32 block mode serves on the f32 kernel (g)
    check_serving_precision(exp, torch.device("cuda"), mode="block")


def test_train_cli_fp32_on_cuda_without_a_card_fails_on_the_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["--precision", "fp32", "--device", "cuda",
                       "--data-root", str(tmp_path / "missing"),
                       "--save-dir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


def test_gemm_bwd_f32_layout_takes_the_training_buffers():
    # the f32 training backward's operands: dcat column slices at the block
    # widths (stride 308), pitched activations, contiguous [m, c] gradients
    m, f32 = 64, torch.float32
    dcat = torch.zeros(m, 308)
    for c in (180, 212, 244, 276):
        gb.check_bwd_f32_layout("t", dcat[:, c:c + 32], c,
                                pitched(m, c, dtype=f32),
                                torch.zeros(32, c),
                                out=torch.zeros(m, c))
        gb.check_bwd_f32_layout("t", torch.zeros(m, c), 2 * c,
                                pitched(m, 2 * c, dtype=f32),
                                torch.zeros(c, 2 * c),
                                out=pitched(m, 2 * c, dtype=f32))


@pytest.mark.parametrize("bad", ["dtype", "offset", "stride", "width"])
def test_gemm_bwd_f32_layout_refuses_what_the_kernel_cannot_read(bad):
    m = 64
    wide = torch.zeros(m, 310)
    dy, w, a = wide[:, :180], torch.zeros(180, 180), torch.zeros(m, 180)
    if bad == "dtype":
        a = a.to(torch.bfloat16)
    elif bad == "offset":
        dy = wide[:, 2:182]                  # 8 bytes past alignment
    elif bad == "stride":
        dy = torch.zeros(m, 182)[:, :180]    # a row stride of 182
    else:
        dy, w = torch.zeros(m, 178), torch.zeros(178, 180)
    with pytest.raises(ValueError):
        gb.check_bwd_f32_layout("t", dy, 180, w, a, out=torch.zeros(m, 180))
