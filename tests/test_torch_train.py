"""The port's training side on the CPU against the JAX package: losses and
the validation metrics, the LR schedule, the epoch sampler, one train step
and a one-epoch Trainer run (f32, tiny configs, inputs from numpy seeds)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu import metrics as jmetrics
from adsr_tpu.core.config import DataConfig as JaxData
from adsr_tpu.core.config import Experiment as JaxExperiment
from adsr_tpu.core.config import OptimConfig as JaxOptim
from adsr_tpu.data import pipeline as jpipe
from adsr_tpu.train import losses as jlosses
from adsr_tpu.train import trainer as jtrainer

from adsr_tpu_torch import metrics as pmetrics
from adsr_tpu_torch.core.config import DataConfig, Experiment, OptimConfig
from adsr_tpu_torch.data.pipeline import EpochSampler, SRDataset, sample_batch
from adsr_tpu_torch.io.convert import drct_state_dict_from_jax
from adsr_tpu_torch.train import losses as plosses
from adsr_tpu_torch.train import trainer as ptrainer

from torch_port_util import jax_params

SPECS = ["1*L1", "1*MSE", "1*PSNR", "1*SSIM", "0.5*L1+0.25*SSIM+2*MSE"]


def _sr_hr(shape, seed=0):
    rng = np.random.RandomState(seed)
    hr = (rng.rand(*shape) * 255).astype(np.float32)
    sr = np.clip(hr + rng.randn(*shape).astype(np.float32) * 20, -10, 265)
    return sr.astype(np.float32), hr


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("shape", [(2, 32, 32, 1), (2, 24, 24, 3)])
def test_make_loss_matches_jax(spec, shape):
    sr, hr = _sr_hr(shape)
    jtotal, jcomps = jlosses.make_loss(spec, batch_size=2, scale=4)(
        jnp.asarray(sr), jnp.asarray(hr))
    ptotal, pcomps = plosses.make_loss(spec, batch_size=2, scale=4)(
        torch.from_numpy(sr), torch.from_numpy(hr))
    assert set(pcomps) == set(jcomps)
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=1e-5)
    for k in jcomps:
        np.testing.assert_allclose(float(pcomps[k]), float(jcomps[k]),
                                   rtol=1e-5, err_msg=k)


def test_parse_loss_spec():
    assert plosses.parse_loss_spec("1*L1+0.5*SSIM") == \
        jlosses.parse_loss_spec("1*L1+0.5*SSIM")
    with pytest.raises(ValueError):
        plosses.parse_loss_spec("1*VGG")


@pytest.mark.parametrize("shape", [(3, 32, 32, 1), (2, 20, 20, 3),
                                   (2, 8, 8, 1)])
def test_shave4_metrics_match_jax(shape):
    sr, hr = _sr_hr(shape, seed=1)
    for name in ("psnr_shave4", "ssim_shave4"):
        want = np.asarray(getattr(jmetrics, name)(jnp.asarray(sr),
                                                  jnp.asarray(hr), 255.0))
        got = getattr(pmetrics, name)(torch.from_numpy(sr),
                                      torch.from_numpy(hr), 255.0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_ssim_map_zero_padding_matches_jax():
    # per pixel, sigma = box(a*a) - box(a)^2 cancels in f32 whatever the
    # padding: an absolute 1e-5 on a map of order 1
    rng = np.random.RandomState(2)
    a, b = (rng.rand(2, 16, 16, 1).astype(np.float32) for _ in range(2))
    for padding in ("reflect", "zero"):
        want = np.asarray(jmetrics.ssim_map(jnp.asarray(a), jnp.asarray(b), 7,
                                            1e-4, 9e-4, padding))
        got = pmetrics.ssim_map(torch.from_numpy(a), torch.from_numpy(b), 7,
                                1e-4, 9e-4, padding).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("epoch,epochs", [(0, 10), (3, 10), (9, 10), (5, 6)])
def test_cosine_lr_matches_jax(epoch, epochs):
    assert ptrainer.cosine_lr(epoch, 2e-4, 1e-7, epochs) == \
        pytest.approx(jtrainer.cosine_lr(epoch, 2e-4, 1e-7, epochs), rel=1e-12)


def _dataset(n, hr_size, scales_desc, seed=0, jax_side=False):
    """Block-average LR pyramid of a random HR set (the JAX suite's
    synthetic_sr_dataset)."""
    rng = np.random.RandomState(seed)
    hr = (rng.rand(n, hr_size, hr_size, 1) * 255).astype(np.float32)
    lrs = [hr.reshape(n, hr_size // s, s, hr_size // s, s, 1).mean(axis=(2, 4))
           for s in scales_desc]
    cls = jpipe.SRDataset if jax_side else SRDataset
    return cls(hr=hr, lrs=lrs, scales_desc=tuple(scales_desc),
               filenames=[f"{i:03d}" for i in range(n)])


@pytest.mark.parametrize("seed,epoch,n,test_every", [
    (1, 0, 5, 4), (1, 3, 5, 4), (7, 2, 3, 5), (123, 11, 8, 2)])
def test_epoch_order_matches_jax_sampler(monkeypatch, seed, epoch, n,
                                         test_every):
    seen = []

    def spy(hr, lrs, idx, key, patch_size, scales_desc, augment):
        seen.extend(np.asarray(idx).tolist())
        return [lrs[0][:1]], hr[:1]

    monkeypatch.setattr(jpipe, "sample_batch", spy)
    jsampler = jpipe.EpochSampler(_dataset(n, 16, (2,), jax_side=True), 2,
                                  test_every, 16, False, seed=seed)
    list(jsampler.epoch(epoch))
    psampler = EpochSampler(_dataset(n, 16, (2,)), 2, test_every, 16, False,
                            seed=seed, device="cpu")
    assert psampler.order(epoch).tolist() == seen
    batches = list(psampler.epoch(epoch))
    assert len(batches) == psampler.batches_per_epoch == test_every
    assert batches[0][1].shape == (2, 16, 16, 1)


def test_epoch_sampler_puts_the_dataset_on_the_card_by_default():
    ds = _dataset(2, 16, (2,))
    if torch.cuda.is_available():
        assert EpochSampler(ds, 2, 1, 16, False)._hr.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EpochSampler(ds, 2, 1, 16, False)
    assert EpochSampler(ds, 2, 1, 16, False, device="cpu")._hr.device.type \
        == "cpu"


def test_sample_batch_crops_align_and_flip_together():
    # HR 48 px, patch 16, scales 4 and 2: crops aligned to 4 px, the same
    # region in HR and every LR, one flip/transpose draw for all of them
    n, size, tp = 6, 48, 16
    rng = np.random.RandomState(3)
    hr = torch.from_numpy(rng.rand(n, size, size, 1).astype(np.float32))
    lrs = [hr.reshape(n, size // s, s, size // s, s, 1).mean(dim=(2, 4))
           for s in (4, 2)]
    idx = [0, 3, 5, 3, 1, 2, 4, 0]
    gen = torch.Generator().manual_seed(0)
    lr_b, hr_b = sample_batch(hr, lrs, idx, gen, tp, (4, 2), augment=True)
    assert hr_b.shape == (8, tp, tp, 1)
    assert [t.shape for t in lr_b] == [(8, 4, 4, 1), (8, 8, 8, 1)]
    seen_aug = set()
    for i, img in enumerate(idx):
        found = []
        for y0 in range(0, size - tp + 1, 4):
            for x0 in range(0, size - tp + 1, 4):
                base = hr[img, y0:y0 + tp, x0:x0 + tp]
                for hf in (0, 1):
                    for vf in (0, 1):
                        for rt in (0, 1):
                            t = base.flip(1) if hf else base
                            t = t.flip(0) if vf else t
                            t = t.transpose(0, 1) if rt else t
                            if torch.equal(t, hr_b[i]):
                                found.append((y0, x0, hf, vf, rt))
        assert len(found) == 1, found
        y0, x0, hf, vf, rt = found[0]
        seen_aug.add((hf, vf, rt))
        for lr, s, got in zip(lrs, (4, 2), lr_b):
            t = lr[img, y0 // s:(y0 + tp) // s, x0 // s:(x0 + tp) // s]
            t = t.flip(1) if hf else t
            t = t.flip(0) if vf else t
            t = t.transpose(0, 1) if rt else t
            assert torch.equal(t, got[i])
    assert len(seen_aug) > 1          # the flips are drawn, not fixed
    _, hr_plain = sample_batch(hr, lrs, idx, torch.Generator().manual_seed(0),
                               tp, (4, 2), augment=False)
    assert hr_plain.shape == hr_b.shape


def _exps(**optim):
    """The same tiny experiment for both packages (num_layers 1: every
    drop-path rate is 0, so the stochastic step is deterministic)."""
    _, pcfg, _ = jax_params("fixup")
    jcfg, _, _ = jax_params("fixup")
    kw = dict(resolution=16, patch_size=16, scale=(2,), n_colors=1,
              batch_size=2, test_every=2)
    ok = dict(lr=1e-3, epochs=2, **optim)
    jexp = JaxExperiment(model=jcfg, data=JaxData(**kw),
                         optim=JaxOptim(**ok), save="/tmp/t",
                         precision="fp32", print_every=1)
    pexp = Experiment(model=pcfg, data=DataConfig(**kw),
                      optim=OptimConfig(**ok), save="/tmp/t",
                      precision="fp32", print_every=1)
    return jexp, pexp


def _jax_step(monkeypatch, jexp, lrs, hr, error_last=1e8, steps=1):
    monkeypatch.setenv("ADSR_TPU_FUSED_TRAIN", "0")
    step, init_state, _ = jtrainer.make_train_step(jexp)
    state = init_state(jax.random.key(0))
    # a host copy: the step donates its state
    params0 = jax.tree_util.tree_map(np.array, state.params["primal"])
    out = []
    for i in range(steps):
        state, metrics = step(state, [jnp.asarray(lr) for lr in lrs],
                              jnp.asarray(hr), 1e-3, jax.random.key(1),
                              error_last)
        out.append(float(metrics["total"]))
    return params0, state, out


def _port_state(pexp, params0):
    bundle = ptrainer.make_train_step(pexp, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(drct_state_dict_from_jax(params0,
                                                         pexp.model))
    return bundle, state


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_train_step_matches_jax(monkeypatch, weight_decay):
    jexp, pexp = _exps(weight_decay=weight_decay)
    rng = np.random.RandomState(3)
    lrs = [(rng.rand(2, 8, 8, 1) * 255).astype(np.float32)]
    hr = (rng.rand(2, 16, 16, 1) * 255).astype(np.float32)
    params0, jstate, jloss = _jax_step(monkeypatch, jexp, lrs, hr, steps=2)
    bundle, state = _port_state(pexp, params0)
    ploss = []
    for _ in range(2):
        state, metrics = bundle.step(state, [torch.from_numpy(lrs[0])],
                                     torch.from_numpy(hr), 1e-3,
                                     torch.Generator().manual_seed(1))
        ploss.append(float(metrics["total"]))
    assert state.step == 2 and not bundle.use_fused_train
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    want = drct_state_dict_from_jax(jstate.params["primal"], pexp.model)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-5,
                                   err_msg=k)


def test_skipped_step_leaves_params_and_moments(monkeypatch):
    jexp, pexp = _exps(skip_threshold=1.5)
    rng = np.random.RandomState(4)
    lrs = [(rng.rand(2, 8, 8, 1) * 255).astype(np.float32)]
    hr = (rng.rand(2, 16, 16, 1) * 255).astype(np.float32)
    params0, _, _ = _jax_step(monkeypatch, jexp, lrs, hr, error_last=0.0)
    bundle, state = _port_state(pexp, params0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    args = ([torch.from_numpy(lrs[0])], torch.from_numpy(hr), 1e-3)
    # error_last = 0: every positive loss is a spike, the step is skipped
    state, metrics = bundle.step(state, *args,
                                 torch.Generator().manual_seed(1), 0.0)
    assert float(metrics["skipped"]) == 1.0
    assert all(torch.equal(before[k], v)
               for k, v in state.model.state_dict().items())
    assert len(state.optimizer.state) == 0           # no moments were made
    state, metrics = bundle.step(state, *args,
                                 torch.Generator().manual_seed(1), 1e8)
    assert float(metrics["skipped"]) == 0.0
    moments = [s["exp_avg"] for s in state.optimizer.state.values()]
    assert moments and any(bool(m.abs().sum() > 0) for m in moments)
    assert not all(torch.equal(before[k], v)
                   for k, v in state.model.state_dict().items())


def test_trainer_epoch_and_test_match_jax_metrics(monkeypatch, capsys):
    _, pexp = _exps()
    pexp = dataclasses.replace(pexp, optim=dataclasses.replace(
        pexp.optim, epochs=1), print_every=1)
    tr = ptrainer.Trainer(pexp, _dataset(4, 16, (2,)),
                          _dataset(3, 16, (2,), seed=1), device="cpu")
    mean = tr.train_one_epoch()
    assert tr.epoch == 1 and tr.terminate()
    assert len(tr.loss_history) == 1 and set(mean) == {"total", "L1"}
    assert tr.error_last == mean["total"] and np.isfinite(mean["total"])
    assert "[Epoch 1]" in capsys.readouterr().out
    srs = []
    orig = tr.eval_forward
    tr.eval_forward = lambda p, lr: srs.append(orig(p, lr)) or srs[-1]
    p, s = tr.test()
    sr = torch.cat(srs).numpy()
    hr = tr.test_ds.hr
    want_p = np.mean(np.asarray(jmetrics.psnr_shave4(jnp.asarray(sr),
                                                     jnp.asarray(hr), 255.0)))
    want_s = np.mean(np.asarray(jmetrics.ssim_shave4(jnp.asarray(sr),
                                                     jnp.asarray(hr), 255.0)))
    assert p == pytest.approx(float(want_p), rel=1e-5)
    assert s == pytest.approx(float(want_s), rel=1e-5, abs=1e-6)
    assert tr.best["PSNR"] == (p, 1) and tr.psnr_ssim_history == [(p, s)]
    # the eval SR is quantised to the 0-255 grid
    np.testing.assert_array_equal(sr, np.round(sr))


def test_trainer_refuses_a_journal():
    # the Trainer takes the port's io.journal.Journal (tests/
    # test_torch_journal.py) and refuses anything else
    _, pexp = _exps()
    with pytest.raises(TypeError, match="Journal"):
        ptrainer.Trainer(pexp, None, None, journal=object(), device="cpu")
