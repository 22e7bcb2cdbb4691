"""The port's scratch-teacher distillation and ``cli.efficientad`` on the
CPU: the augmentation against the JAX one on the same masks, distillation
against the JAX one from the same weights, distillation lowering its loss
into a teacher the trainer loads, the CLI's flag surface
against the JAX CLI's, the card as its default with no fallback, and a
whole CPU run on a small synthetic tree written at 64 px, so the loaders'
bilinear resize to 256 px runs (inputs from seeds)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.cli import efficientad as jcli
from adsr_tpu.models.efficientad import PDN as JaxPDN
from adsr_tpu.models.factory import fast_init
from adsr_tpu.train import distill as jdistill

from adsr_tpu_torch.cli import efficientad as pcli
from adsr_tpu_torch.data.synthetic import generate_synthetic_mvtec
from adsr_tpu_torch.io.convert import pdn_state_dict_from_jax
from adsr_tpu_torch.io.journal import load_state_dict
from adsr_tpu_torch.train import distill as pdistill
from adsr_tpu_torch.train.distill import augment, distill_teacher
from adsr_tpu_torch.train.efficientad import EADConfig, EfficientADTrainer


def test_augment_matches_jax_on_the_same_masks():
    """``distill.py``'s augment: the width flip, then rot90(x, 2) over
    (H, W), where each mask is true."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 6, 5, 3).astype(np.float32)
    flip = np.array([0, 1, 0, 1, 1, 0, 0, 1], bool)
    rot = np.array([0, 0, 1, 1, 0, 1, 0, 1], bool)
    xj = jnp.asarray(x)
    want = jnp.where(flip[:, None, None, None], xj[:, :, ::-1, :], xj)
    want = np.asarray(jnp.where(rot[:, None, None, None],
                                jnp.rot90(want, 2, axes=(1, 2)), want))
    got = augment(torch.from_numpy(x), torch.from_numpy(flip),
                  torch.from_numpy(rot)).numpy()
    np.testing.assert_array_equal(got, want)


def _symmetric_images():
    """Two copies of a 64 px pattern that the width flip and the 180-degree
    rotation leave as it is, so every step regresses the same targets and
    the loss falls step by step (on noise images the augmented batches'
    losses scatter by +-50% around 1 for tens of steps)."""
    c = np.arange(64) - 31.5
    img = (0.5 + 0.25 * np.cos(2 * np.pi * c[:, None] / 8)
           * np.cos(2 * np.pi * c[None, :] / 11)
           + 0.2 * np.cos(2 * np.pi * c[None, :] / 5) ** 2)
    return np.stack([np.stack([img, img ** 2, 1 - img], -1)] * 2) \
        .astype(np.float32)


# The oracle's channel variance is E[f^2] - mean^2 in f32 in both packages;
# where |mean| >> std (up to 19x on these images) it cancels, and JAX's own
# std is 4.6e-5 off its f64 value: the losses agree to 1.3e-5 relative
DISTILL_LOSS_RTOL = 1e-4
# the log prints 4 decimals: one unit of the last digit and f32 noise
DISTILL_LOG_ATOL = 1.5e-4
# each teacher leaf's update over the steps, relative L2: Adam moves an
# element whose |g| is near its eps with g's f32 noise (8.1e-4 seen)
DISTILL_UPDATE_REL_L2 = 3e-3


def test_distill_matches_jax(monkeypatch):
    """Both ``distill_teacher``s from the JAX package's oracle and teacher
    weights (``fast_init`` at ``fold_in(key, 0)`` and ``fold_in(key, 1)``),
    carried into the port, 3 steps at the default lr on images the flip and
    the rotation leave unchanged, so only the shared index stream
    ``RandomState(seed + 1)`` picks the batches: the oracle's statistics,
    the normalised target and the Adam regression give the same logged
    losses, the same returned loss and the same teacher."""
    imgs = _symmetric_images()
    key = jax.random.key(0)
    dummy = jnp.zeros((1, 64, 64, 3))
    params = [fast_init(JaxPDN(16, size).init, jax.random.fold_in(key, i),
                        dummy)["params"]
              for i, size in enumerate(("medium", "small"))]
    carried = iter([pdn_state_dict_from_jax(params[0], "medium"),
                    pdn_state_dict_from_jax(params[1], "small")])

    def jax_init(module, generator=None):
        module.load_state_dict(next(carried))   # the oracle, then the teacher
        return module

    monkeypatch.setattr(pdistill, "init_efficientad_", jax_init)
    jlog, plog = [], []
    jparams, jloss = jdistill.distill_teacher(16, "small", imgs, steps=3,
                                              batch=2, seed=0,
                                              log=jlog.append)
    sd, loss = distill_teacher(16, "small", imgs, steps=3, batch=2, seed=0,
                               log=plog.append, device="cpu")
    assert next(carried, None) is None
    np.testing.assert_allclose(loss, jloss, rtol=DISTILL_LOSS_RTOL)
    losses = [[float(line.rsplit(" ", 1)[-1]) for line in log]
              for log in (plog, jlog)]
    assert len(losses[0]) == 3
    np.testing.assert_allclose(*losses, rtol=0, atol=DISTILL_LOG_ATOL)
    assert losses[1][0] > 0.9 and losses[1][-1] < 0.5   # it regresses
    want = pdn_state_dict_from_jax(jparams, "small")
    start = pdn_state_dict_from_jax(params[1], "small")
    assert set(sd) == set(want)
    for k, v in sd.items():
        moved = (want[k] - start[k]).norm()
        assert moved > 0, k
        assert (v - want[k]).norm() / moved <= DISTILL_UPDATE_REL_L2, k


def test_distill_lowers_its_loss_into_a_loadable_teacher():
    """30 steps at 64 px: the feature-regression MSE (1 at the start: the
    oracle's features are standardised) falls below half its first reading,
    and the teacher's state_dict loads into the trainer's small teacher."""
    imgs = _symmetric_images()
    t = torch.from_numpy(imgs)
    ones = torch.ones(2, dtype=torch.bool)
    assert torch.equal(augment(t, ones, ones), t)
    logged = []
    sd, loss = distill_teacher(16, "small", imgs, steps=30, batch=2,
                               lr=1e-3, seed=0, log=logged.append,
                               device="cpu")
    first = float(logged[0].rsplit(" ", 1)[-1])
    assert len(logged) == 10 and 0.9 < first < 1.1
    assert np.isfinite(loss) and loss < 0.5 * first
    trainer = EfficientADTrainer(EADConfig(out_channels=16), device="cpu")
    trainer.teacher.load_state_dict(sd)


def test_parse_args_has_the_jax_flag_surface():
    """The JAX CLI's flags and defaults, but ``--device``: {cuda, cpu},
    default cuda (the JAX one's auto / tpu / cpu)."""
    want = vars(jcli.parse_args([]))
    got = vars(pcli.parse_args([]))
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in want.items() if k != "device"}
    assert got["device"] == "cuda"
    assert pcli.parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        pcli.parse_args(["--device", "auto"])


def test_cli_and_distill_need_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["--dataset-path", str(tmp_path / "none"),
                   "--output-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distill_teacher(8, "small", np.zeros((1, 64, 64, 3), np.float32))


def test_cli_scratch_teacher_run_on_the_cpu(tmp_path, capsys):
    """``--teacher scratch`` end to end on 64 px PNGs resized to 256: the
    distilled teacher, the temporary and final checkpoints as ``.pt``
    state_dicts, an evaluation after step 0 and ``final_metrics.json``
    with the JAX CLI's keys."""
    generate_synthetic_mvtec(str(tmp_path / "data"), classes=("grid",),
                             n_train=4, n_test_good=2,
                             n_test_bad_per_defect=1, size=64, seed=3)
    out = tmp_path / "out"
    auc = pcli.main(["--dataset-path", str(tmp_path / "data"),
                     "--subdataset", "grid", "--train-steps", "3",
                     "--batch-size", "1", "--teacher", "scratch",
                     "--distill-steps", "2", "--eval-after", "0",
                     "--eval-every", "2", "--device", "cpu",
                     "--output-dir", str(out)])
    text = capsys.readouterr().out
    assert "train=3 val=1 test=4 device=cpu" in text
    assert "Current AUC:" in text and "Final image auc:" in text
    run = out / "grid_3"
    for name in ("teacher_distilled", "student_tmp", "autoencoder_tmp",
                 "teacher_final", "student_final", "autoencoder_final"):
        assert (run / f"{name}.pt").is_file(), name
    teacher = EfficientADTrainer(EADConfig(), device="cpu").teacher
    teacher.load_state_dict(load_state_dict(run / "teacher_final.pt"))
    assert set(load_state_dict(run / "student_final.pt")) == {
        f"{i}.{k}" for i in (0, 3, 6, 8) for k in ("weight", "bias")}
    fm = json.loads((run / "final_metrics.json").read_text())
    assert set(fm) == {"auc", "threshold", "accuracy", "precision",
                       "recall", "f1", "train_time_h"}
    assert fm["auc"] == auc and 0.0 <= auc <= 1.0
