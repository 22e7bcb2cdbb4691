"""The port's DRN-L training on the CPU against the JAX package: one
dual-regression step (loss terms, every gradient of primal and duals, the
parameters after one Adam step), the Trainer's epochs, its dual
checkpoints and a true resume, the serving forwards' full-scale output, and
the card as the default with no fallback (f32, tiny widths, inputs from
numpy seeds)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.core.config import DataConfig as JaxData
from adsr_tpu.core.config import Experiment as JaxExperiment
from adsr_tpu.core.config import OptimConfig as JaxOptim
from adsr_tpu.train import trainer as jtrainer

from adsr_tpu_torch.core.config import DataConfig, Experiment, OptimConfig
from adsr_tpu_torch.core.device import full_f32
from adsr_tpu_torch.io.convert import drn_duals_from_jax, drn_state_dict_from_jax
from adsr_tpu_torch.io.journal import Journal, load_state_dict
from adsr_tpu_torch.train import trainer as ptrainer

from test_torch_train import _dataset
from torch_port_util import drn_jax_params

LR_RATE = 1e-3


def _exps(scale=(2, 4), n_colors=1, batch=2, hr=32, **optim):
    jcfg, pcfg, params, duals = drn_jax_params(scale, n_colors)
    kw = dict(resolution=hr, patch_size=hr, scale=scale, n_colors=n_colors,
              batch_size=batch, test_every=2)
    ok = dict(lr=LR_RATE, epochs=3, **optim)
    jexp = JaxExperiment(model=jcfg, data=JaxData(**kw), optim=JaxOptim(**ok),
                         save="/tmp/t", precision="fp32", print_every=1)
    pexp = Experiment(model=pcfg, data=DataConfig(**kw),
                      optim=OptimConfig(**ok), save="/tmp/t",
                      precision="fp32", print_every=1)
    return jexp, pexp, params, duals


def _batch(scale, n_colors, batch=2, hr=32, seed=3):
    """An HR batch and its block-average LR pyramid, descending scale."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(batch, hr, hr, n_colors) * 255).astype(np.float32)
    lrs = [x.reshape(batch, hr // s, s, hr // s, s, n_colors).mean(axis=(2, 4))
           for s in sorted(scale, reverse=True)]
    return lrs, x


def _port_state(pexp, params, duals):
    bundle = ptrainer.make_train_step(pexp, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(drn_state_dict_from_jax(params, pexp.model))
    for d, sd in zip(state.duals, drn_duals_from_jax(duals, pexp.model)):
        d.load_state_dict(sd)
    return bundle, state


def _rel_l2(got, want):
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


@pytest.mark.parametrize("scale,n_colors,weight_decay", [
    ((2, 4), 1, 0.0), ((2,), 3, 1e-2)])
def test_dual_step_matches_jax(monkeypatch, scale, n_colors, weight_decay):
    """One step of both packages from the same params: total / primary /
    dual within 1e-4, every gradient leaf of primal and duals within a
    relative L2 of 1e-4 (the gradient that enters the moments, g + wd p:
    the JAX one read off Adam's first moment, mu = (1 - b1) (g + wd p)),
    and the parameters after the Adam step within 1e-4."""
    monkeypatch.setenv("ADSR_TPU_FUSED_TRAIN", "0")
    jexp, pexp, params, duals = _exps(scale, n_colors,
                                      weight_decay=weight_decay)
    lrs, hr = _batch(scale, n_colors)
    jb = jtrainer.make_train_step(jexp)
    state = jb.init_state(jax.random.key(0))
    jparams = {"primal": params, "duals": duals}
    state = state.replace(params=jparams,
                          opt_state=jb.optimizer.init(jparams))
    state, jm = jb.step(state, [jnp.asarray(lr) for lr in lrs],
                        jnp.asarray(hr), LR_RATE, jax.random.key(1))
    mu = state.opt_state[-1].mu
    b1 = jexp.optim.beta1
    jgrad = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - b1), mu)

    bundle, pstate = _port_state(pexp, params, duals)
    pstate, pm = bundle.step(pstate, [torch.from_numpy(lr) for lr in lrs],
                             torch.from_numpy(hr), LR_RATE,
                             torch.Generator().manual_seed(1))
    assert set(pm) == {"total", "primary", "dual"} and pstate.step == 1
    for k in ("total", "primary", "dual"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)

    cfg = pexp.model
    pairs = [(pstate.model, drn_state_dict_from_jax(jgrad["primal"], cfg),
              drn_state_dict_from_jax(params, cfg),
              drn_state_dict_from_jax(state.params["primal"], cfg))]
    pairs += list(zip(pstate.duals, drn_duals_from_jax(jgrad["duals"], cfg),
                      drn_duals_from_jax(duals, cfg),
                      drn_duals_from_jax(state.params["duals"], cfg)))
    for module, grads, before, after in pairs:
        named = dict(module.named_parameters())
        assert set(named) == set(grads)
        for k, p in named.items():
            g = grads[k].numpy()
            entering = p.grad.numpy() + weight_decay * before[k].numpy()
            assert _rel_l2(entering, g) <= 1e-4, k
            # Adam's first step moves p by lr * g / (|g| + eps), which
            # moves with g's f32 noise dg by lr * eps * dg / (|g| + eps)^2.
            # Where |g| is within 100 eps of 0 that is a visible share of
            # the step (seen: g ~ 1e-8 +- 2e-10 moves it by 5e-3 of lr), so
            # there both steps are held to their bound, lr; elsewhere it is
            # at most ~1e-5 of lr (seen: 6.5e-9 at g ~ 1e-6)
            near_eps = np.abs(g) < 100 * jexp.optim.epsilon
            got, want = p.detach().numpy(), after[k].numpy()
            np.testing.assert_allclose(got[~near_eps], want[~near_eps],
                                       rtol=1e-4, atol=1e-5 * LR_RATE,
                                       err_msg=k)
            np.testing.assert_allclose(got[near_eps], want[near_eps],
                                       rtol=0, atol=LR_RATE, err_msg=k)


def _train_exp(tmp_path, epochs):
    _, pexp, _, _ = _exps(hr=16)
    pexp = dataclasses.replace(pexp, save=str(tmp_path),
                               optim=dataclasses.replace(pexp.optim,
                                                         epochs=epochs))
    return pexp


def test_trainer_loss_falls_over_three_epochs():
    """As the JAX suite's ``test_drn_loss_decreases``
    (tests/test_train.py:140-147): three epochs on four images."""
    exp = _train_exp("/tmp/t", epochs=3)
    tr = ptrainer.Trainer(exp, _dataset(4, 16, (4, 2)),
                          _dataset(2, 16, (4, 2), seed=1), device="cpu")
    first = tr.train_one_epoch()
    for _ in range(2):
        last = tr.train_one_epoch()
    assert set(first) == {"total", "primary", "dual"}
    assert np.isfinite(last["total"]) and last["total"] < first["total"]
    assert tr.terminate()
    p, s = tr.test()
    assert np.isfinite(p) and -1 <= s <= 1


def test_journal_writes_duals_and_resume_equals_the_uninterrupted_run(
        tmp_path):
    exp = _train_exp(tmp_path / "a", epochs=2)
    ds = _dataset(4, 16, (4, 2))
    straight = ptrainer.Trainer(exp, ds, None, device="cpu")
    straight.train_one_epoch()
    straight.train_one_epoch()

    exp_b = dataclasses.replace(exp, save=str(tmp_path / "b"))
    first = ptrainer.Trainer(exp_b, ds, _dataset(2, 16, (4, 2), seed=1),
                             journal=Journal(exp_b), device="cpu")
    first.train_one_epoch()
    first.save_train_state()
    first.test()
    model_dir = tmp_path / "b" / "model"
    assert sorted(p.name for p in model_dir.iterdir()) == [
        "dual_model_best.pt", "dual_model_latest.pt", "model_best.pt",
        "model_latest.pt", "train_state_latest.pt"]
    saved = load_state_dict(model_dir / "dual_model_latest.pt")
    assert isinstance(saved, list) and len(saved) == 2
    for sd, dual in zip(saved, first.state.duals):
        assert all(torch.equal(sd[k], v) for k, v in dual.state_dict().items())

    resumed = ptrainer.Trainer(exp_b, ds, None, journal=Journal(exp_b),
                               device="cpu")
    resumed.load_train_state()
    assert resumed.epoch == 1 and resumed.state.step == first.state.step
    resumed.train_one_epoch()
    assert resumed.state.step == straight.state.step == 4
    assert resumed.loss_history == straight.loss_history[1:]
    for got, want in [(resumed.state.model, straight.state.model)] + list(
            zip(resumed.state.duals, straight.state.duals)):
        want_sd = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, want_sd[k]), k


def test_serving_forwards_take_the_full_scale_output():
    """``make_serving_forward``, ``make_eval_forward`` and the tiled forward
    (3 x 3 tiles of 4 LR px) return ``sr[-1]``, quantised or raw, as the
    JAX forwards do."""
    jexp, pexp, params, _ = _exps(n_colors=3)
    x = (np.random.RandomState(5).rand(2, 8, 8, 3) * 255).astype(np.float32)
    want = np.asarray(jtrainer.make_serving_forward(jexp, params)(
        jnp.asarray(x)))
    sd = drn_state_dict_from_jax(params, pexp.model)
    got = ptrainer.make_serving_forward(pexp, sd, device="cpu")(x)
    assert got.shape == (2, 32, 32, 3)
    # the quantised SR: a value within f32 noise of a half step can round
    # either way
    assert np.abs(got.numpy() - want).max() <= 1.0
    assert np.mean(got.numpy() != want) < 1e-3
    raw = ptrainer.make_serving_forward(pexp, sd, device="cpu",
                                        quantize_out=False)(x)
    evaled = ptrainer.make_eval_forward(pexp, device="cpu",
                                        quantize_out=False)(sd, x)
    assert torch.equal(raw, evaled)
    want_tiled = np.asarray(jtrainer.make_tiled_serving_forward(
        jexp, params, tile=4, overlap=2, quantize_out=False)(jnp.asarray(x)))
    tiled = ptrainer.make_tiled_serving_forward(
        pexp, sd, tile=4, overlap=2, device="cpu", quantize_out=False)(x)
    np.testing.assert_allclose(tiled.numpy() / 255, want_tiled / 255,
                               atol=2e-3, rtol=1e-3)


def test_drn_precision_on_the_card_and_no_fallback():
    """DRN runs no kernel of the port: both precisions pass the card's
    check (DRCT's fp32 refusals in block mode and training stay,
    tests/test_torch_serving.py); and a DRN request on the card without one
    raises."""
    _, pexp, params, _ = _exps()
    for precision in ("bf16", "fp32"):
        ptrainer.check_serving_precision(
            dataclasses.replace(pexp, precision=precision),
            torch.device("cuda"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    sd = drn_state_dict_from_jax(params, pexp.model)
    for make in (lambda: ptrainer.make_train_step(pexp),
                 lambda: ptrainer.make_serving_forward(pexp, sd),
                 lambda: ptrainer.make_tiled_serving_forward(pexp, sd),
                 lambda: ptrainer.Trainer(pexp, None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_full_f32_scope_restores_the_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
