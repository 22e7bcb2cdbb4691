"""The port's whole training forward (``fused_drct_train_forward`` on CPU
tensors, every kernel wrapper on its plain version) against the JAX fused
training forward in interpret mode, with the same drop-path multipliers."""

import os

os.environ["ADSR_TPU_PALLAS_INTERPRET"] = "1"

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.ops import fused_rdg_train as jfrt

from adsr_tpu_torch.kernels import fused_rdg_train as frt
from adsr_tpu_torch.kernels import rdg_gemm_bwd as gb
from adsr_tpu_torch.kernels import rdg_layernorm_bwd as lb
from adsr_tpu_torch.kernels import window_attention_bwd as ab
from adsr_tpu_torch.models.factory import make_model

from torch_port_util import ATOL, RTOL, jax_params, lr_input, port_state_dict

BWD_WRAPPERS = (gb.rdg_gemm_dgrad, gb.rdg_gemm_wgrad, lb.rdg_layernorm_bwd,
                ab.window_attention_bwd)


def _model(name):
    model = make_model(jax_params(name)[1], device="cpu")
    model.load_state_dict(port_state_dict(name))
    return model


@pytest.mark.parametrize("name", ["tiny", "fixup", "window8", "rgb"])
def test_train_forward_matches_jax_fused_train(monkeypatch, name):
    monkeypatch.setattr(jfrt, "_INTERPRET", True)
    jcfg, pcfg, params = jax_params(name)
    x = lr_input(jcfg)
    key = jax.random.key(5)
    dp = np.array(jfrt.drop_path_mults(key, jcfg, x.shape[0], False))
    want = np.asarray(jfrt.fused_drct_train_forward(
        params, jcfg, jnp.asarray(x), rng=key, deterministic=False,
        dtype=jnp.float32))
    model = _model(name)
    for fn in BWD_WRAPPERS:
        fn.launches = 0
    got = frt.fused_drct_train_forward(dict(model.named_parameters()), pcfg,
                                       torch.from_numpy(x),
                                       torch.from_numpy(dp),
                                       dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    with torch.no_grad():
        eager = model(torch.from_numpy(x), dp=torch.from_numpy(dp))
    np.testing.assert_allclose(got.detach().numpy(), eager.numpy(),
                               atol=1e-4, rtol=1e-4)
    got.sum().backward()                        # CPU: the plain versions
    assert [fn.launches for fn in BWD_WRAPPERS] == [0, 0, 0, 0]
