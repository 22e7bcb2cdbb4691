"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA card with nvcc (sm_90a build) and skip elsewhere. The
card's machine has no JAX, so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from adsr_tpu_torch.core.config import DRCTModelConfig
from adsr_tpu_torch.kernels import _build
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.rdg_gemm import rdg_gemm, rdg_gemm_plain
from adsr_tpu_torch.kernels.rdg_layernorm import (rdg_layernorm,
                                                  rdg_layernorm_plain)
from adsr_tpu_torch.kernels.window_attention import (window_attention,
                                                     window_attention_plain)
from adsr_tpu_torch.models.drct import shift_attn_mask
from adsr_tpu_torch.models.factory import init_sr_params, make_model

pytestmark = pytest.mark.cuda

# window 8 (the kernel's), embed 12: dims 12..28, head dims 6..14
CFG = DRCTModelConfig(upscale=2, img_size=16, window_size=8, in_chans=1,
                      embed_dim=12, num_layers=2, num_heads=2, gc=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol):
    err = (got.float() - want).abs()
    assert bool((err <= atol + 2.0 ** -7 * want.abs()).all()), err.max()


def test_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    m, c, nh = 2 * 32 * 32, 212, 4
    cat = torch.randn(m, 308, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(c, generator=g, device=dev)
    b = torch.randn(c, generator=g, device=dev)
    out = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
    n0 = rdg_layernorm.launches
    rdg_layernorm(cat[:, :c], w, b, out)
    assert rdg_layernorm.launches == n0 + 1
    _close(out, rdg_layernorm_plain(cat[:, :c].float(), w, b), 1e-4)

    wt = (0.05 * torch.randn(32, c, generator=g, device=dev)).to(torch.bfloat16)
    bias = torch.randn(32, generator=g, device=dev)
    dst = cat.clone()
    rdg_gemm(cat[:, :c], wt, bias, dst[:, c:c + 32], "leaky_relu")
    _close(dst[:, c:c + 32], rdg_gemm_plain(cat[:, :c].float(), wt.float(),
                                            bias, "leaky_relu"), 1e-3)
    assert torch.equal(dst[:, :c], cat[:, :c])     # other columns untouched

    qkv = torch.randn(m, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    tb = torch.randn(nh, 64, 64, generator=g, device=dev)
    mask = torch.as_tensor(shift_attn_mask(32, 32, 8, 4), device=dev)
    ctx = torch.empty(m, c, dtype=torch.bfloat16, device=dev)
    window_attention(qkv, ctx, tb, mask, 32, 32, nh, 8, 4)
    atol = 2.0 ** -8 * qkv[:, 2 * c:].float().abs().max().item()
    _close(ctx, window_attention_plain(qkv.float(), tb, mask, 32, 32, nh, 8,
                                       4), atol)


def test_fused_forward_counts_launches_and_tracks_eager(dev):
    sd, _ = init_sr_params(CFG, torch.Generator().manual_seed(0), device=dev)
    packed = prepack_drct(sd, CFG, 16, 16, dtype=torch.bfloat16, device=dev)
    x = 255 * torch.rand(2, 16, 16, 1, device=dev)
    for fn in (rdg_layernorm, rdg_gemm, window_attention):
        fn.launches = 0
    with torch.no_grad():
        got = fused_drct_apply(packed, CFG, x)
        model = make_model(CFG, device=dev)
        model.load_state_dict(sd)
        want = model(x)
    torch.cuda.synchronize()
    per_rdg = (10, 25, 5)
    assert [rdg_layernorm.launches, rdg_gemm.launches,
            window_attention.launches] == [n * CFG.num_layers for n in per_rdg]
    rel = (got - want).norm() / want.norm()
    assert rel < 5e-2, rel


def test_fp32_on_the_card_raises(dev):
    x = torch.zeros(64, 12, device=dev)
    with pytest.raises(NotImplementedError, match="fp32 serving kernels"):
        rdg_layernorm(x, torch.ones(12, device=dev), torch.zeros(12, device=dev),
                      torch.empty_like(x))
    assert _build.library() is not None
