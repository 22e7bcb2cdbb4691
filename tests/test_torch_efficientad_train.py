"""The port's EfficientAD trainer on the CPU against the JAX package, at 256
px (the autoencoder's only size), batch 1 and 8 output channels, on weights
carried across (``io/convert.py``): teacher normalisation with a short last
batch, one train step with and without the penalty (loss terms, the
gradients that enter Adam, the parameters after it), the maps' quantiles,
``test_auc`` and ``test_auc_grouped``, the learning-rate schedule and the
teacher's ``.pt`` loading (inputs from numpy seeds)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.train import efficientad as jead

from adsr_tpu_torch.io.convert import (autoencoder_state_dict_from_jax,
                                       pdn_state_dict_from_jax)
from adsr_tpu_torch.io.journal import save_state_dict
from adsr_tpu_torch.train import efficientad as pead

CFG = dict(train_steps=10, batch_size=1, image_size=256, out_channels=8)
TERM_RTOL = 1e-5         # each loss term of one f32 step
GRAD_REL_L2 = 1e-4       # each gradient leaf, relative L2
# the maps are means of squared differences of two f32 outputs (teacher -
# student, autoencoder - student), whose ~1e-6 relative errors the
# difference magnifies: 3.6e-5 seen on the autoencoder map's 0.9 quantile
MAP_RTOL = 1e-4
LR = 1e-4


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.02 * rng.randn(*np.shape(a)).astype(np.float32)),
        tree)


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """One JAX trainer (its init compiles for seconds) and its perturbed
    params as numpy trees, so biases are not zero."""
    jt = jead.EfficientADTrainer(jead.EADConfig(**CFG), log=lambda *_: None)
    params = {"teacher": _perturbed(jt.teacher_params, 1),
              "student": _perturbed(jt.state.student, 2),
              "autoencoder": _perturbed(jt.state.autoencoder, 3)}
    return jt, params


def _pair():
    """(JAX trainer, port trainer) from the same params, the JAX step count
    and Adam state fresh."""
    jt, params = _jax_trainer()
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jt.teacher_params = tree(params["teacher"])
    opt_params = {"student": tree(params["student"]),
                  "autoencoder": tree(params["autoencoder"])}
    jt.state = jead.EADState(step=jnp.asarray(0),
                             student=opt_params["student"],
                             autoencoder=opt_params["autoencoder"],
                             opt_state=jt.optimizer.init(opt_params))
    jt.teacher_mean = jnp.zeros((1, 1, 1, CFG["out_channels"]))
    jt.teacher_std = jnp.ones((1, 1, 1, CFG["out_channels"]))
    pt = pead.EfficientADTrainer(pead.EADConfig(**CFG), log=lambda *_: None,
                                 device="cpu")
    pt.teacher.load_state_dict(pdn_state_dict_from_jax(params["teacher"]))
    pt.student.load_state_dict(pdn_state_dict_from_jax(params["student"]))
    pt.autoencoder.load_state_dict(
        autoencoder_state_dict_from_jax(params["autoencoder"]))
    return jt, pt


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 256, 256, 3).astype(np.float32)


def _normalized_pair():
    jt, pt = _pair()
    imgs = _images(3, 0)
    jt.teacher_normalization(imgs, batch=2)
    pt.teacher_normalization(imgs, batch=2)
    return jt, pt


def test_teacher_normalization_matches_jax():
    """Three images at batch 2: the short last batch weighs as much as the
    full one, in both packages; mean and std within 1e-5 relative."""
    jt, pt = _normalized_pair()
    for got, want in ((pt.teacher_mean, jt.teacher_mean),
                      (pt.teacher_std, jt.teacher_std)):
        want = np.asarray(want).ravel()
        np.testing.assert_allclose(got.numpy().ravel(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    imgs = _images(3, 0)
    with torch.no_grad():
        outs = [pt.teacher(pt._nchw(imgs[i:i + 2])) for i in (0, 2)]
    pooled = torch.cat(outs).mean(dim=(0, 2, 3))
    assert not torch.allclose(pooled, pt.teacher_mean.ravel(), rtol=1e-3)


def _rel_l2(got, want):
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


@pytest.mark.parametrize("penalty", [False, True], ids=["plain", "penalty"])
def test_train_step_matches_jax(penalty):
    """One step of both from the same state on the draws JAX makes: every
    loss term within 1e-5 relative; every gradient leaf that enters Adam
    (g + wd p; the JAX one read off Adam's first moment, mu = (1 - b1)
    (g + wd p)) within a relative L2 of 1e-4; the parameters after the Adam
    step within 1e-4 relative, and within lr where |g| is near eps (there
    Adam's step moves with g's f32 noise; tests/test_torch_drn_train.py)."""
    jt, pt = _normalized_pair()
    img = _images(1, 1)
    pen = _images(1, 2) if penalty else None
    key = jax.random.key(4)
    kc, kf = jax.random.split(key)
    pick = (np.array(jax.random.bernoulli(jax.random.fold_in(key, 7), 0.3,
                                          (1, 1, 1, 1))).ravel()
            if penalty else None)
    draws = pead.StepDraws(
        torch.from_numpy(np.array(jax.random.randint(kc, (1,), 0, 3))),
        torch.from_numpy(np.array(jax.random.uniform(kf, (1,), minval=0.8,
                                                     maxval=1.2))),
        None if pick is None else torch.from_numpy(pick))
    before = {"student": {k: v.clone() for k, v in
                          pt.student.state_dict().items()},
              "autoencoder": {k: v.clone() for k, v in
                              pt.autoencoder.state_dict().items()}}

    jm = jt.train_step(jnp.asarray(img), jnp.asarray(img), key,
                       None if pen is None else jnp.asarray(pen))
    pm = pt.train_step(img, img, draws, pen)
    assert set(pm) == set(jm) == ({"total", "hard", "ae", "stae"}
                                  | ({"penalty"} if penalty else set()))
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=TERM_RTOL, err_msg=k)
    assert pt.step == 1 and int(jt.state.step) == 1

    mu = jt.state.opt_state[1].mu
    wd = pt.cfg.weight_decay
    for name, module, to_port in (
            ("student", pt.student, pdn_state_dict_from_jax),
            ("autoencoder", pt.autoencoder,
             autoencoder_state_dict_from_jax)):
        jgrad = to_port(jax.tree_util.tree_map(
            lambda m: np.asarray(m) / 0.1, mu[name]))
        after = to_port(jax.tree_util.tree_map(np.asarray,
                                               getattr(jt.state, name)))
        named = dict(module.named_parameters())
        assert set(named) == set(jgrad)
        for k, p in named.items():
            g = jgrad[k].numpy()
            entering = p.grad.numpy() + wd * before[name][k].numpy()
            assert _rel_l2(entering, g) <= GRAD_REL_L2, (name, k)
            near_eps = np.abs(g) < 100 * 1e-8
            got, want = p.detach().numpy(), after[k].numpy()
            np.testing.assert_allclose(got[~near_eps], want[~near_eps],
                                       rtol=1e-4, atol=1e-5 * LR,
                                       err_msg=f"{name}.{k}")
            np.testing.assert_allclose(got[near_eps], want[near_eps],
                                       rtol=0, atol=LR, err_msg=f"{name}.{k}")


def test_maps_quantiles_and_auc_match_jax():
    """map_normalization's four quantiles and test_auc's scores within
    ``MAP_RTOL``, the same AUC; test_auc_grouped's scores and AUC on
    part-numbered names."""
    jt, pt = _normalized_pair()
    val = _images(3, 5)
    test = _images(4, 6)
    test[2:] = np.clip(test[2:] * 1.5, 0, 1)     # "defects": more contrast
    labels = ["good", "good", "crack", "crack"]
    jq = jt.map_normalization(val, batch=2)
    pq = pt.map_normalization(val, batch=2)
    np.testing.assert_allclose(pq, jq, rtol=MAP_RTOL)
    assert pq[0] <= pq[1] and pq[2] <= pq[3]
    jauc, jy, js = jt.test_auc(test, labels, jq)
    pauc, py, ps = pt.test_auc(test, labels, jq)
    assert py == jy == [0, 0, 1, 1]
    np.testing.assert_allclose(ps, js, rtol=MAP_RTOL)
    assert pauc == jauc and 0.0 <= pauc <= 1.0
    maps = pt.predict_combined(test, jq)
    assert maps.shape == (4, 56, 56) and maps.dtype == np.float32
    paths = [f"/t/{lab}/{i:03d}_{i}.png" for i, lab in
             zip((0, 20, 1, 29), labels)]
    jg = jt.test_auc_grouped(test, labels, paths, jq, group_div=14)
    pg = pt.test_auc_grouped(test, labels, paths, jq, group_div=14)
    assert pg[1] == jg[1]
    np.testing.assert_allclose(pg[2], jg[2], rtol=MAP_RTOL)
    assert pg[0] == jg[0]
    with pytest.raises(ValueError, match="Only one class"):
        pt.test_auc_grouped(test[:2], labels[:2], paths[:2], jq)


def test_step_lr_matches_jax():
    jt, _ = _jax_trainer()
    pt = pead.EfficientADTrainer(pead.EADConfig(**CFG), device="cpu")
    for step in range(12):
        assert pt.step_lr(step) == jt.step_lr(step)
    assert pt.step_lr(9) == pytest.approx(0.1 * pt.cfg.lr)


def test_load_teacher_reads_pt_and_refuses_msgpack(tmp_path):
    src = pead.EfficientADTrainer(pead.EADConfig(**CFG, seed=7),
                                  log=lambda *_: None, device="cpu")
    dst = pead.EfficientADTrainer(pead.EADConfig(**CFG), log=lambda *_: None,
                                  device="cpu")
    save_state_dict(tmp_path / "teacher.pth", src.teacher.state_dict())
    dst.load_teacher(str(tmp_path / "teacher.pth"))
    for k, v in src.teacher.state_dict().items():
        assert torch.equal(dst.teacher.state_dict()[k], v)
    with pytest.raises(ValueError, match="msgpack"):
        dst.load_teacher(str(tmp_path / "teacher.msgpack"))


def test_trainer_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pead.EfficientADTrainer(pead.EADConfig(**CFG))
