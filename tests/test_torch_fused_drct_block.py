"""The port's block serving mode (each Swin block through kernel (g), plain
path on CPU tensors) against the JAX package's block mode in interpret mode
and against the port's rdg mode; the ``ADSR_TPU_RDG`` switch."""

import os

os.environ["ADSR_TPU_PALLAS_INTERPRET"] = "1"

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adsr_tpu.ops.fused_drct import fused_drct_apply as jax_apply
from adsr_tpu.ops.fused_drct import prepack_drct as jax_prepack

from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.kernels import fused_drct as fd
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.train.trainer import make_serving_forward

from torch_port_util import ATOL, RTOL, jax_params, lr_input, port_state_dict
from test_torch_serving import _experiments, _weights


def _packed(name, mode=None):
    _, pcfg, _ = jax_params(name)
    return pcfg, prepack_drct(port_state_dict(name), pcfg, pcfg.img_size,
                              pcfg.img_size, dtype=torch.float32,
                              device="cpu", mode=mode)


def test_block_mode_matches_jax_block_mode():
    # tiny: embed 12, gc 4, heads 2, 2 RDGs, img 8, window 4, x2
    jcfg, _, params = jax_params("tiny")
    cfg, packed = _packed("tiny", "block")
    x = lr_input(jcfg)
    jp = jax_prepack(params, jcfg, jcfg.img_size, jcfg.img_size,
                     dtype=jnp.float32, mode="block")
    want = np.asarray(jax_apply(jp, jcfg, x, dtype=jnp.float32))
    with torch.no_grad():
        got = fused_drct_apply(packed, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["window8", "window16"])
def test_fp32_block_mode_matches_jax_block_mode(name):
    # the JAX block mode at f32 (its Pallas kernel at dtype f32, in
    # interpret mode) against the port's block mode on f32 CPU tensors
    # (kernel (g)'s plain path, the f32 instance's reference)
    jcfg, _, params = jax_params(name)
    cfg, packed = _packed(name, "block")
    x = lr_input(jcfg)
    jp = jax_prepack(params, jcfg, jcfg.img_size, jcfg.img_size,
                     dtype=jnp.float32, mode="block")
    want = np.asarray(jax_apply(jp, jcfg, x, dtype=jnp.float32))
    with torch.no_grad():
        got = fused_drct_apply(packed, cfg, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["tiny", "fixup", "window8"])
def test_block_mode_matches_rdg_mode(name):
    cfg, packed = _packed(name)
    x = torch.from_numpy(lr_input(jax_params(name)[0]))
    taps_b, taps_r = [], []
    with torch.no_grad():
        block = fused_drct_apply(packed, cfg, x, taps_b, mode="block")
        rdg = fused_drct_apply(packed, cfg, x, taps_r, mode="rdg")
    # the same plain functions in the same order: equal to f32 rounding
    np.testing.assert_allclose(block.numpy(), rdg.numpy(), atol=1e-4,
                               rtol=1e-5)
    for a, b in zip(taps_b, taps_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_block_mode_reads_the_packed_dicts_themselves(monkeypatch):
    # kernel (g) takes the packed matrices in their 16-byte rows: block mode
    # hands it the packed block dicts as they are, with no second copy
    cfg, packed = _packed("tiny", "block")
    keys = set(packed)
    seen = []
    real = fd.fused_swin_block

    def spy(x, p, masks, cfg_, h, w, k, out):
        seen.append(p)
        return real(x, p, masks, cfg_, h, w, k, out)

    monkeypatch.setattr(fd, "fused_swin_block", spy)
    x = torch.from_numpy(lr_input(jax_params("tiny")[0]))
    with torch.no_grad():
        fused_drct_apply(packed, cfg, x)
    want = [p for blocks in packed["rdgs"] for p in blocks]
    assert len(seen) == len(want) == 5 * cfg.num_layers
    assert all(a is b for a, b in zip(seen, want))
    assert set(packed) == keys                       # nothing added
    for p in want:
        for n in ("wqkv", "wproj", "w1", "w2"):
            assert p[n].stride(1) == 1 and p[n].stride(0) % 8 == 0


def test_adsr_tpu_rdg_0_selects_block_mode(monkeypatch):
    calls = []
    real = fd.fused_swin_block

    def spy(*args, **kw):
        calls.append(args[6])                    # block index k
        return real(*args, **kw)

    monkeypatch.setattr(fd, "fused_swin_block", spy)
    jexp, pexp = _experiments()
    _, sd = _weights()
    x = torch.from_numpy(lr_input(jax_params("tiny")[0]))
    monkeypatch.setenv("ADSR_TPU_RDG", "0")
    assert fd.resolve_mode() == "block"
    block = make_serving_forward(pexp, sd, device="cpu")(x)
    assert calls == [0, 1, 2, 3, 4] * pexp.model.num_layers
    monkeypatch.setenv("ADSR_TPU_RDG", "1")
    assert fd.resolve_mode() == "rdg"
    calls.clear()
    rdg = make_serving_forward(pexp, sd, device="cpu")(x)
    assert calls == []
    torch.testing.assert_close(block, rdg)          # quantized: same grid
    monkeypatch.delenv("ADSR_TPU_RDG")
    assert fd.resolve_mode() == "rdg"
    with pytest.raises(ValueError):
        fd.resolve_mode("window")


def test_anomaly_server_block_mode_scores_match_rdg_mode():
    _, pexp = _experiments()
    _, sd = _weights()
    rng = np.random.RandomState(4)
    lr = rng.randint(0, 256, (5, 8, 8, 3), np.uint8)
    hr = rng.randint(0, 256, (5, 16, 16, 3), np.uint8)
    scores = []
    for mode in ("rdg", "block"):
        server = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
        server.register("grid", pexp, sd, mode=mode)
        scores.append(server.score("grid", lr, hr))
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-5, atol=1e-6)
