"""fp32 DRCT serving and evaluation: the route rule on each device, the
evaluation CLI's default precision against the JAX CLI's, the f32 kernels'
launch plans and layout rules on tensor metadata (no card needed), and the
port's fp32 ``AnomalyServer`` and ``evaluate_anomaly`` in rdg and in block
mode against the JAX package's at windows 8 and 16 (window 4:
``tests/test_torch_serving.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from adsr_tpu.cli import evaluate as jax_cli_eval
from adsr_tpu.core import config as jc
from adsr_tpu.eval.evaluate import evaluate_anomaly as jax_evaluate
from adsr_tpu.eval.serving import AnomalyServer as JaxServer

from adsr_tpu_torch.cli import evaluate as cli_eval
from adsr_tpu_torch.cli import main as cli_main
from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.eval.evaluate import evaluate_anomaly
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels import rdg_gemm as gemm_mod
from adsr_tpu_torch.kernels import rdg_layernorm as ln_mod
from adsr_tpu_torch.kernels import window_attention as attn_mod
from adsr_tpu_torch.kernels import fused_swin_block as swin_mod
from adsr_tpu_torch.kernels.fused_drct import resolve_mode
from adsr_tpu_torch.kernels.fused_rdg import (block_buffers, rdg_geometry,
                                              rdg_workspace)
from adsr_tpu_torch.train.trainer import (check_serving_precision,
                                          check_training_precision)

from torch_port_util import CONFIGS, jax_params

FLAGSHIP = pc.drct_experiment("grid", 128, 4, run_tag="t").model
WRAPPERS = (ln_mod.rdg_layernorm, gemm_mod.rdg_gemm,
            attn_mod.window_attention, swin_mod.fused_swin_block)


def _launches():
    return [(fn.launches, fn.launches_f32) for fn in WRAPPERS]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("mode", ["rdg", "block"])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_route_rule(precision, mode, device):
    """Serving: the card takes bf16 and fp32 in both modes (the f32
    instances of (a)-(c) and of (g)). Training: the card takes both (the
    f32 instances of (a)-(f)). The CPU's plain path takes everything."""
    exp = pc.drct_experiment("grid", 128, 4, run_tag="t",
                             precision=precision)
    dev = torch.device(device)
    check_serving_precision(exp, dev, mode)
    check_training_precision(exp, dev)
    with pytest.raises(ValueError, match="unknown fused DRCT mode"):
        check_serving_precision(exp, dev, "window")


def test_route_rule_reads_adsr_tpu_rdg(monkeypatch):
    exp = pc.drct_experiment("grid", 128, 4, run_tag="t", precision="fp32")
    for flag, mode in (("0", "block"), ("1", "rdg")):
        monkeypatch.setenv("ADSR_TPU_RDG", flag)
        assert resolve_mode() == mode
        check_serving_precision(exp, torch.device("cuda"))


def test_evaluate_cli_default_precision_is_the_jax_clis():
    assert cli_eval.parse_args([]).precision == \
        jax_cli_eval.parse_args([]).precision == "fp32"


def test_train_cli_refuses_fp32_on_the_card_before_reading_data(tmp_path):
    # fp32 trains on the card; without one the device error comes first (no
    # data root exists, no run dir is made, nothing falls back to the CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["--precision", "fp32", "--device", "cuda",
                       "--data-root", str(tmp_path / "missing"),
                       "--save-dir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("window", [4, 8, 16])
@pytest.mark.parametrize("c,nh", [(180, 6), (212, 4), (244, 2), (276, 6),
                                  (308, 4), (12, 2), (16, 2)])
def test_f32_attention_plan_fits_the_card(window, c, nh):
    side = 16 if window == 4 else (32 if window == 8 else 64)
    plan = attn_mod.window_attention_f32_plan(c, nh, 16, side, side, window)
    n = window * window
    rows = min(n, 64)
    hdp = -(-(c // nh) // 16) * 16
    assert plan["rows"] == rows and plan["key_tiles"] == n // rows
    assert plan["hdp"] == hdp and plan["pitch"] == hdp + 4
    # the q, k and v planes; a warp per 16 query rows, two threads a row
    assert plan["smem_bytes"] == 4 * 3 * rows * (hdp + 4)
    assert plan["threads"] == 2 * rows == 32 * (rows // 16)
    assert plan["smem_bytes"] <= attn_mod.BLOCK_SHARED_MAX
    assert plan["blocks_per_sm"] >= 1
    assert plan["max_registers"] * plan["threads"] * plan["min_blocks"] \
        <= attn_mod.REGISTERS
    windows = 16 * (side // window) ** 2
    assert plan["blocks"] == windows * nh * (n // rows)
    # eight consecutive staged rows start in eight 16-byte bank groups
    assert len({(r * plan["pitch"] * 4) % 128 for r in range(8)}) == 8


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("hr,batch", [(128, 16), (128, 5), (256, 16),
                                      (256, 5), (64, 16), (64, 5)])
def test_f32_swin_block_plan_fits_the_card(hr, batch, k):
    """Kernel (g)'s f32 plan at every block of the flagship (window 8),
    256px/x4 (16) and 64/x4 (4) models (widths 180-308, heads 6/4/2/6/4,
    hidden 360/424/488/276/308), at batch 16 and at batch 5 (at 64/x4 on 20
    x 20 tokens: a short last group): one block an SM's shared memory, the
    regions summing to it, a cluster the card launches."""
    cfg = pc.drct_experiment("grid", hr, 4, run_tag="t").model
    geo = swin_mod.block_geometry(cfg, k)
    c, f, nh = geo["c"], geo["hidden"], geo["heads"]
    assert (c, nh, f) == ((180, 6, 360), (212, 4, 424), (244, 2, 488),
                          (276, 6, 276), (308, 4, 308))[k]
    win = cfg.window_size
    side = 20 if (win == 4 and batch == 5) else cfg.img_size
    plan = swin_mod.swin_block_f32_plan(c, f, nh, batch, side, side, win)
    assert plan["smem_bytes"] <= attn_mod.BLOCK_SHARED_MAX
    assert plan["smem_bytes"] == sum(plan["regions"].values())
    # the source's order: row offsets, LN statistics, the key halves' merge,
    # act (context, then the hidden chunk), the union, the ring
    assert list(plan["regions"]) == ["rows", "ln_stats", "merge", "act",
                                     "union", "ring"]
    hdp = -(-(c // nh) // 16) * 16
    # the union holds the q, k, v planes or the stream y [64][ldc]
    assert plan["planes"] == 4 * 3 * 64 * (hdp + 4)
    assert plan["y"] == 4 * 64 * plan["ldc"]
    assert plan["regions"]["union"] == max(plan["planes"], plan["y"])
    # act holds the context [64][ldc], then the hidden chunk [64][136]
    assert plan["regions"]["act"] == 4 * 64 * max(plan["ldc"], 136)
    # at 16x16 windows the ring also holds a peer's K or V plane
    assert plan["stage"] == (4 * 64 * (hdp + 4) if win == 16 else 0)
    assert plan["regions"]["ring"] == max(plan["stage"], 3 * 128 * 40 * 4)
    # act's rows hold c rounded up to a product's K step of 32, and a
    # half-warp's 8-byte fragment pairs sit in 32 different banks
    assert plan["ldc"] >= c and plan["ldc"] % 32 == 8
    assert plan["threads"] == 256 and plan["stages"] == 3
    windows = batch * (side // win) ** 2
    assert plan["windows"] == windows
    assert plan["cluster"] == (4 if win == 16 else 1)    # <= 8: portable
    assert plan["blocks"] % plan["cluster"] == 0
    if win == 4:
        assert plan["blocks"] == -(-windows // 4)
        assert plan["last_group"] == windows - 4 * (plan["blocks"] - 1)
        assert plan["last_group"] == (1 if batch == 5 else 4)
    else:
        assert plan["blocks"] == windows * plan["cluster"]


def test_f32_gemm_plan_covers_the_flagships_products():
    g = rdg_geometry(FLAGSHIP)
    m = 16 * 32 * 32
    flops = 0
    for c, f, a in zip(g["feats"], g["hidden"], g["adj_out"]):
        for n_out, k in ((3 * c, c), (c, c), (f, c), (c, f), (a, c)):
            plan = gemm_mod.gemm_f32_plan(m, n_out, k)
            bm, bn = plan["tile"]
            assert bm == 128 and bn in gemm_mod.F32_WIDTHS
            assert plan["units"] == (m // 128) * -(-n_out // bn)
            assert plan["grid"] == min(plan["units"], 132)
            assert plan["k_steps"] == -(-k // gemm_mod.F32_BK)
            assert plan["padded_flops"] >= 2 * m * n_out * k
            assert plan["tf32_flops"] == 3 * plan["padded_flops"]
            flops += 2 * m * n_out * k
    # one flagship RDG's 25 products are 72.3 GFLOP (the f32 bound's count)
    assert flops / 1e9 == pytest.approx(72.3, abs=0.05)
    # persistent: no grid dimension limits M
    assert gemm_mod.gemm_f32_plan(4 * m, 924, 308)["grid"] == 132


@pytest.mark.parametrize("m", [4096, 16384, 65536, 3 * 1004])
def test_f32_gemm_plans_fit_the_card_and_wgmma(m):
    # every flagship product's plan at windows 4, 8 and 16 (and the card
    # test's ragged M): its ring fits 227 KB of dynamic shared memory, a
    # stage is [A hi | W hi | A lo | W lo] of 128-byte rows (the swizzle's
    # span) in whole 1024-byte blocks, the wgmma is m64nBNk8 with a legal N
    # (a multiple of 8 up to 256), and the tile width takes the fewest
    # rounds of the persistent grid
    g = rdg_geometry(FLAGSHIP)
    for c, f, a in zip(g["feats"], g["hidden"], g["adj_out"]):
        for n_out, k in ((3 * c, c), (c, c), (f, c), (c, f), (a, c)):
            plan = gemm_mod.gemm_f32_plan(m, n_out, k)
            bn = plan["tile"][1]
            assert plan["smem_bytes"] <= 232448
            assert gemm_mod.F32_BK * 4 == 128
            assert plan["stage_bytes"] == 2 * (128 + bn) * 128
            assert plan["stage_bytes"] % 1024 == 0
            assert 3 <= plan["stages"] <= 6
            assert plan["wgmma"] == (64, bn, 8)
            assert bn % 8 == 0 and 8 <= bn <= 256
            rounds = {w: -(-(-(-m // 128) * -(-n_out // w)) // 132)
                      for w in gemm_mod.F32_WIDTHS}
            cost = {w: r * (w + 32) for w, r in rounds.items()}
            assert cost[bn] == min(cost.values())


def test_main_path_f32_layouts_take_wide_pieces():
    """Every buffer an f32 kernel of the main path loads has 16-byte rows:
    (a) takes 16-byte pieces on the concat prefix and on x1, (c) the
    16-byte rows rule on qkv and ctx, and (b) its rules on every operand."""
    g = rdg_geometry(FLAGSHIP)
    m = 2 * 32 * 32
    work = rdg_workspace(m, FLAGSHIP, torch.float32, "cpu")
    cat = torch.empty(m, g["cat_width"], dtype=torch.float32)
    for c, f in zip(g["feats"], g["hidden"]):
        bufs = block_buffers(work, m, c, f)
        assert ln_mod.check_ln_layout("t", cat[:, :c], bufs["ln1"]) == 16
        assert ln_mod.check_ln_layout("t", bufs["x1"], bufs["ln2"]) == 16
        attn_mod.check_rows16("t", bufs["qkv"], bufs["ctx"])
        w = torch.empty(c, 3 * c)
        gemm_mod.check_gemm_layout("t", c, bufs["ln1"], w, bufs["qkv"])
        gemm_mod.check_gemm_layout("t", f, bufs["hid"], torch.empty(c, f),
                                   bufs["x2"], bufs["x1"])
        gemm_mod.check_gemm_layout("t", c, bufs["x2"], torch.empty(32, c),
                                   cat[:, c:c + 32])


def test_f32_layout_rules():
    x = torch.empty(64, 312, dtype=torch.float32)
    out = torch.empty(64, 180, dtype=torch.float32)
    # a base one float past alignment: single values
    assert ln_mod.check_ln_layout("t", x[:, 1:181], out) == 4
    assert ln_mod.check_ln_layout("t", x[:, 4:184], out) == 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm_mod.check_gemm_layout("t", 180, x[:, 2:182],
                                   torch.empty(32, 180), out[:, :32])
    # an f32 output may sit at any row stride (one float a thread)
    gemm_mod.check_gemm_layout("t", 180, x[:, :180], torch.empty(30, 180),
                               torch.empty(64, 37)[:, 3:33])
    with pytest.raises(ValueError, match="16-byte rows"):
        attn_mod.check_rows16("t", torch.empty(64, 3 * 178)[:, :534])


# a window-8 config whose block 1 (k = 0: width 12, no shift) kernel (g)'s
# meta-tensor cases call
SWIN_CFG = pc.DRCTModelConfig(upscale=2, img_size=16, window_size=8,
                              in_chans=1, embed_dim=12, num_layers=1,
                              num_heads=2, gc=4)


def _swin_call(dtype):
    """Kernel (g)'s wrapper on "meta" tensors of ``dtype`` (block 1 of
    ``SWIN_CFG`` at batch 2)."""
    meta = dict(device="meta", dtype=dtype)
    p = {n: torch.empty(24, 12, **meta) for n in ("wqkv", "wproj", "w1",
                                                  "w2")}
    return lambda: swin_mod.fused_swin_block(
        torch.empty(512, 12, **meta), p, {}, SWIN_CFG, 16, 16, 0,
        torch.empty(512, 12, **meta))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_are_refused_on_the_card_route(dtype):
    # the kernels' type rule names bf16 and f32; on the card's route
    # ("meta" tensors take it) a tensor of another type raises in each of
    # (a), (b), (c) and (g) before any launch (meta is not CUDA: the device
    # check comes first), and the launch counters do not move
    with pytest.raises(NotImplementedError, match="take bf16 or f32"):
        _build.kernel_dtype("t", _build.BF16_F32,
                            torch.empty(4, 4, dtype=dtype))
    meta = dict(device="meta", dtype=dtype)
    f32 = dict(device="meta")
    n0 = _launches()
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        ln_mod.rdg_layernorm(torch.empty(16, 8, **meta),
                             torch.empty(8, **f32), torch.empty(8, **f32),
                             torch.empty(16, 8, **meta))
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        gemm_mod.rdg_gemm(torch.empty(16, 8, **meta), torch.empty(4, 8, **meta),
                          torch.empty(4, **f32), torch.empty(16, 4, **meta))
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        attn_mod.window_attention(torch.empty(128, 36, **meta),
                                  torch.empty(128, 12, **meta),
                                  torch.empty(2, 64, 64, **f32), None, 8, 16,
                                  2, 8, 0)
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        _swin_call(dtype)()
    assert _launches() == n0


@pytest.mark.parametrize("wrapper", ["rdg_layernorm", "rdg_gemm",
                                     "window_attention", "fused_swin_block"])
def test_f32_reaches_the_device_check(wrapper):
    # f32 passes the type check of (a), (b), (c) and (g) and stops at the
    # device check (meta is not CUDA)
    meta = dict(device="meta")
    calls = {
        "rdg_layernorm": lambda: ln_mod.rdg_layernorm(
            torch.empty(16, 8, **meta), torch.empty(8, **meta),
            torch.empty(8, **meta), torch.empty(16, 8, **meta)),
        "rdg_gemm": lambda: gemm_mod.rdg_gemm(
            torch.empty(16, 8, **meta), torch.empty(4, 8, **meta),
            torch.empty(4, **meta), torch.empty(16, 4, **meta)),
        "window_attention": lambda: attn_mod.window_attention(
            torch.empty(128, 36, **meta), torch.empty(128, 12, **meta),
            torch.empty(2, 64, 64, **meta), None, 8, 16, 2, 8, 0),
        "fused_swin_block": _swin_call(torch.float32)}
    n0 = _launches()
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        calls[wrapper]()
    assert _launches() == n0


@pytest.mark.parametrize("window,embed,item", [(2, 12, "Queue 2 item 1"),
                                               (8, 324, "Queue 2 item 4")])
def test_swin_block_refusals_name_their_queue_items(window, embed, item):
    # a window or a width kernel (g) does not take raises on the card's
    # route (meta tensors) before the device check, naming where it stands
    cfg = pc.DRCTModelConfig(upscale=2, img_size=16, window_size=window,
                             in_chans=1, embed_dim=embed, num_layers=1,
                             num_heads=4, gc=4)
    meta = dict(device="meta")
    p = {n: torch.empty(8, embed, **meta) for n in ("wqkv", "wproj", "w1",
                                                    "w2")}
    n0 = _launches()
    with pytest.raises(NotImplementedError, match=item):
        swin_mod.fused_swin_block(torch.empty(512, embed, **meta), p, {}, cfg,
                                  16, 16, 0, torch.empty(512, embed, **meta))
    assert _launches() == n0


def test_kernel_dtype_takes_one_dtype_of_the_listed_ones():
    assert _build.kernel_dtype("t", _build.BF16_F32,
                               torch.empty(4, dtype=torch.float32),
                               torch.empty(2, 4)) == torch.float32
    assert _build.kernel_dtype("t", _build.BF16, torch.empty(
        4, dtype=torch.bfloat16)) == torch.bfloat16
    with pytest.raises(NotImplementedError,
                       match=r"take bf16 \(all operands of one type\)"):
        _build.kernel_dtype("t", _build.BF16,
                            torch.empty(4, 4, dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="one type"):
        _build.kernel_dtype("t", _build.BF16_F32,
                            torch.empty(4, 4, dtype=torch.float32),
                            torch.empty(4, 4, dtype=torch.bfloat16))
    # the device check comes first
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        _build.require_cuda("t", _build.BF16_F32,
                            torch.empty(4, 4, dtype=torch.float16))


# ---- fp32 AnomalyServer and evaluate_anomaly against the JAX package ----

SR_OFFSET = 100.0      # lifts the SR off 0, as tests/test_torch_serving.py


def _pair(name, batch=4):
    jcfg, pcfg, params = jax_params(name)
    params = dict(params)
    params["conv_last"] = dict(params["conv_last"])
    params["conv_last"]["bias"] = params["conv_last"]["bias"] + SR_OFFSET
    hr = pcfg.img_size * pcfg.upscale
    kw = dict(resolution=hr, patch_size=hr, scale=(pcfg.upscale,),
              n_colors=1, batch_size=batch, test_every=1)
    jexp = jc.Experiment(model=jc.DRCTModelConfig(**CONFIGS[name]),
                         data=jc.DataConfig(**kw), precision="fp32")
    pexp = pc.Experiment(model=dataclasses.replace(pcfg),
                         data=pc.DataConfig(**kw), precision="fp32")
    return jexp, pexp, params, drct_state_dict_from_jax(params, pcfg)


@pytest.mark.parametrize("name", ["window8", "window16"])
def test_fp32_server_matches_jax(name):
    jexp, pexp, params, sd = _pair(name)
    side = pexp.model.img_size
    hr_side = side * pexp.model.upscale
    rng = np.random.RandomState(3)
    lr = rng.randint(0, 256, (5, side, side, 3), np.uint8)
    hr = rng.randint(0, 256, (5, hr_side, hr_side, 3), np.uint8)
    theirs = JaxServer(batch_size=4, ssim_window=5)
    theirs.register("grid", jexp, params)
    ours = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
    ours.register("grid", pexp, sd, mode="rdg")
    want = theirs.score("grid", lr, hr)
    got = ours.score("grid", lr, hr)
    assert got.shape == (5, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def _write_split(root, split, n, side, scale, rng, defect):
    from PIL import Image
    base = root / "grid" / "test" / split
    (base / "HR").mkdir(parents=True)
    (base / "LR_bicubic" / f"X{scale}").mkdir(parents=True)
    for i in range(n):
        hr = rng.randint(60, 200, (side, side, 3)).astype(np.uint8)
        if defect:
            hr[side // 4:side // 2, side // 4:side // 2] ^= 255
        lr = hr.reshape(side // scale, scale, side // scale, scale, 3) \
            .mean(axis=(1, 3)).astype(np.uint8)
        Image.fromarray(hr).save(base / "HR" / f"{i:03d}.png")
        Image.fromarray(lr).save(base / "LR_bicubic" / f"X{scale}"
                                 / f"{i:03d}x{scale}.png")


def test_fp32_evaluate_anomaly_matches_jax_at_window16(tmp_path):
    jexp, pexp, params, sd = _pair("window16")
    side = pexp.model.img_size * pexp.model.upscale
    rng = np.random.RandomState(4)
    _write_split(tmp_path, "good", 4, side, pexp.model.upscale, rng, False)
    _write_split(tmp_path, "bad", 3, side, pexp.model.upscale, rng, True)
    want = jax_evaluate(jexp, params, str(tmp_path), "grid", out_dir=None,
                        save_images=False, batch=4, log=lambda s: None)
    got = evaluate_anomaly(pexp, sd, str(tmp_path), "grid", batch=4,
                           device="cpu", log=lambda s: None)
    assert got["best_ws"] == want["best_ws"]
    assert got["y_true"] == want["y_true"]
    swap = 1.0 / (4 * 3)   # one swapped rank pair moves an AUC by this
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert abs(got[key] - want[key]) <= swap, key
    for key in ("scores_ssim", "scores_mse", "scores_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["window8", "window16"])
def test_fp32_block_server_matches_jax(name):
    # block mode (each Swin block through kernel (g)'s plain path on the
    # CPU) against the JAX server's fp32 model
    jexp, pexp, params, sd = _pair(name)
    side = pexp.model.img_size
    hr_side = side * pexp.model.upscale
    rng = np.random.RandomState(5)
    lr = rng.randint(0, 256, (5, side, side, 3), np.uint8)
    hr = rng.randint(0, 256, (5, hr_side, hr_side, 3), np.uint8)
    theirs = JaxServer(batch_size=4, ssim_window=5)
    theirs.register("grid", jexp, params)
    ours = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
    ours.register("grid", pexp, sd, mode="block")
    want = theirs.score("grid", lr, hr)
    got = ours.score("grid", lr, hr)
    assert got.shape == (5, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_fp32_block_evaluate_anomaly_matches_jax_at_window16(tmp_path):
    jexp, pexp, params, sd = _pair("window16")
    side = pexp.model.img_size * pexp.model.upscale
    rng = np.random.RandomState(6)
    _write_split(tmp_path, "good", 4, side, pexp.model.upscale, rng, False)
    _write_split(tmp_path, "bad", 3, side, pexp.model.upscale, rng, True)
    want = jax_evaluate(jexp, params, str(tmp_path), "grid", out_dir=None,
                        save_images=False, batch=4, log=lambda s: None)
    got = evaluate_anomaly(pexp, sd, str(tmp_path), "grid", batch=4,
                           device="cpu", log=lambda s: None, mode="block")
    assert got["best_ws"] == want["best_ws"]
    assert got["y_true"] == want["y_true"]
    swap = 1.0 / (4 * 3)   # one swapped rank pair moves an AUC by this
    for key in ("auc_ssim", "auc_mse", "auc_psnr"):
        assert abs(got[key] - want[key]) <= swap, key
    for key in ("scores_ssim", "scores_mse", "scores_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4)
