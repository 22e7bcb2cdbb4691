"""The port's run dirs (``io/journal.py``, ``eval/rundir.py``) and the
Trainer's checkpoints against the JAX package: the same layout and
config.txt keys, ``.pt`` checkpoints that carry into the JAX model, a true
resume, and the same run-dir inference (f32, CPU, tiny configs)."""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch

import jax

from adsr_tpu.eval import rundir as jrundir
from adsr_tpu.io.journal import Journal as JaxJournal
from adsr_tpu.io.torch_convert import convert_drct, stack_scan_layers
from adsr_tpu.models.drct import DRCT as JaxDRCT

from adsr_tpu_torch.core.config import DataConfig, Experiment, OptimConfig
from adsr_tpu_torch.eval import rundir as prundir
from adsr_tpu_torch.io.journal import Journal, load_state_dict
from adsr_tpu_torch.models.factory import init_sr_params, make_model
from adsr_tpu_torch.train.trainer import Trainer

from test_torch_serving import _experiments
from test_torch_train import _dataset
from torch_port_util import ATOL, RTOL, jax_params, lr_input


def _tree(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*"))


def test_run_dir_layout_and_config_match_jax(tmp_path):
    jexp, pexp = _experiments()
    jj = JaxJournal(jexp, save_dir=str(tmp_path / "jax"))
    pj = Journal(pexp, save_dir=str(tmp_path / "port"))
    for j in (jj, pj):
        j.write_log("hello")
        j.log_metrics({"epoch": 1, "total": 1.5})
        j.done()
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    for name in ("log.txt", "metrics.jsonl"):
        assert (tmp_path / "jax" / name).read_text() == \
            (tmp_path / "port" / name).read_text()
    # config.txt: a timestamp line, then the same keys and values
    jlines = (tmp_path / "jax" / "config.txt").read_text().splitlines()
    plines = (tmp_path / "port" / "config.txt").read_text().splitlines()
    assert jlines[1:] == plines[1:] and len(plines) > 40
    assert jrundir.infer_from_run_dir(str(tmp_path / "jax")) == \
        prundir.infer_from_run_dir(str(tmp_path / "port"))


def test_pt_round_trip_and_jax_model_carry(tmp_path):
    # model_latest.pt through convert_drct + stack_scan_layers gives the JAX
    # model the port's forward
    jcfg, pcfg, _ = jax_params("tiny")
    _, pexp = _experiments()
    sd, _ = init_sr_params(pcfg, torch.Generator().manual_seed(3),
                           device="cpu")
    gen = torch.Generator().manual_seed(4)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
          for k, v in sd.items()}
    journal = Journal(pexp, save_dir=str(tmp_path))
    journal.save_model(sd, is_best=True)
    for name in ("model_latest.pt", "model_best.pt"):
        back = load_state_dict(tmp_path / "model" / name)
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], sd[k]) for k in sd)
    back = load_state_dict(tmp_path / "model" / "model_latest.pt")
    tree = stack_scan_layers(convert_drct({k: v.numpy()
                                           for k, v in back.items()}),
                             jcfg.num_layers)
    x = lr_input(jcfg)
    want = np.asarray(JaxDRCT(jcfg).apply(
        {"params": jax.tree_util.tree_map(np.asarray, tree)}, x))
    model = make_model(pcfg, device="cpu")
    model.load_state_dict(back)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _train_exp(tmp_path, epochs):
    _, pcfg, _ = jax_params("tiny")          # 2 RDGs: drop path is live
    return Experiment(model=pcfg,
                      data=DataConfig(resolution=16, patch_size=16,
                                      scale=(2,), n_colors=1, batch_size=2,
                                      test_every=2),
                      optim=OptimConfig(lr=1e-3, epochs=epochs),
                      save=str(tmp_path), precision="fp32", print_every=1)


def test_resumed_trainer_takes_the_uninterrupted_step(tmp_path):
    exp = _train_exp(tmp_path / "a", epochs=2)
    ds = _dataset(4, 16, (2,))
    straight = Trainer(exp, ds, None, device="cpu")
    straight.train_one_epoch()
    straight.train_one_epoch()

    exp_b = dataclasses.replace(exp, save=str(tmp_path / "b"))
    first = Trainer(exp_b, ds, None, journal=Journal(exp_b), device="cpu")
    first.train_one_epoch()
    first.save_train_state()
    resumed = Trainer(exp_b, ds, None, journal=Journal(exp_b), device="cpu")
    resumed.load_train_state()
    assert resumed.epoch == 1 and resumed.state.step == first.state.step
    resumed.train_one_epoch()
    assert resumed.state.step == straight.state.step == 4
    assert resumed.loss_history == straight.loss_history[1:]
    want = straight.state.model.state_dict()
    got = resumed.state.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_trainer_test_saves_latest_and_best(tmp_path):
    exp = _train_exp(tmp_path, epochs=1)
    journal = Journal(exp)
    tr = Trainer(exp, None, _dataset(2, 16, (2,), seed=5), journal=journal,
                 device="cpu")
    tr.test()
    model_dir = tmp_path / "model"
    assert sorted(p.name for p in model_dir.iterdir()) == \
        ["model_best.pt", "model_latest.pt"]
    journal.done()
    assert "PSNR:" in (tmp_path / "log.txt").read_text()


@pytest.mark.parametrize("name", [
    "mvtec_grid_128_X4", "mvtec_carpet_256_X8run", "gkd_DC0_64_X2_12:00:00",
    "notarun", "mvtec_grid_X4"])
def test_run_dir_inference_matches_jax(tmp_path, name):
    run = tmp_path / "drct" / name
    run.mkdir(parents=True)
    assert prundir.infer_from_run_dir(str(run)) == \
        jrundir.infer_from_run_dir(str(run))
    (run / "config.txt").write_text(
        "2026-01-01-00:00:00\n\nmodel_name: drct\ndataset: mvtec\n"
        "classe: carpet\npatch_size: 256\nscale: [4]\nupscale: 4\n"
        "embed_dim: 12\nnum_layers: 2\nnum_heads: 2\ngc: 4\n")
    assert prundir.infer_from_run_dir(str(run)) == \
        jrundir.infer_from_run_dir(str(run))


def test_resolve_checkpoint_order_and_msgpack_error(tmp_path):
    model = tmp_path / "model"
    model.mkdir()
    with pytest.raises(FileNotFoundError, match="--checkpoint"):
        prundir.resolve_checkpoint(str(tmp_path))
    (model / "model_latest.msgpack").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="msgpack.*flax"):
        prundir.resolve_checkpoint(str(tmp_path))
    (model / "model_latest.pt").write_bytes(b"")
    assert prundir.resolve_checkpoint(str(tmp_path)).endswith(
        "model_latest.pt")
    (model / "model_best.pt").write_bytes(b"")
    assert prundir.resolve_checkpoint(str(tmp_path)).endswith("model_best.pt")
    assert prundir.resolve_checkpoint(str(tmp_path), "x.pt") == "x.pt"


class _StubState:
    """What ``Journal.save`` reads of a Trainer's state, with or without
    DRN's dual models."""

    def __init__(self, duals: bool):
        self.model = torch.nn.Linear(3, 2)
        self.duals = [torch.nn.Linear(2, 2)] if duals else None
        self.optimizer = torch.optim.Adam(self.model.parameters())
        self.step = 3

    def dual_state_dicts(self):
        return None if self.duals is None else [d.state_dict()
                                                for d in self.duals]


@pytest.mark.parametrize("kind", ["drct", "drn"])
def test_save_writes_the_jax_plots(tmp_path, kind):
    jexp, pexp = _experiments()
    keys = ("total",) if kind == "drct" else ("total", "primary", "dual")
    losses = [{k: 0.5 / (e + 1) + 0.01 * i for i, k in enumerate(keys)}
              for e in range(3)]
    psnr_ssim = [(21.5, 0.61), (22.25, 0.66), (23.0, 0.7)]
    trainer = types.SimpleNamespace(
        state=_StubState(kind == "drn"), epoch=3, dropout_gen=None,
        error_last=losses[-1]["total"], loss_history=losses,
        psnr_ssim_history=psnr_ssim)
    journal = Journal(pexp, save_dir=str(tmp_path / "port"))
    journal.save(trainer)
    journal.done()
    jj = JaxJournal(jexp, save_dir=str(tmp_path / "jax"))
    jj.plot_loss(losses)
    jj.plot_psnr_ssim(psnr_ssim)
    jj.done()

    def pdfs(root):
        return sorted(p.name for p in root.glob("*.pdf"))
    want = sorted([f"loss_{k}.pdf" for k in keys]
                  + [f"test_{pexp.data.data_test}_psnr_ssim.pdf"])
    assert pdfs(tmp_path / "port") == pdfs(tmp_path / "jax") == want
    # each loss curve: one point an epoch, its heights in the data's order
    for k in keys:
        data = (tmp_path / "port" / f"loss_{k}.pdf").read_bytes()
        content = re.search(rb"stream\n(.*?)\nendstream", data, re.S).group(1)
        curve = re.search(rb"0.1216 0.4667 0.7059 RG 1.500 w \[\] 0 d (.*) S",
                          content).group(1).split()
        heights = [float(v) for v in curve[1::3]]
        assert len(heights) == 3 and heights[0] > heights[1] > heights[2]
        assert f"({k} Loss) Tj".encode() in content


def test_empty_psnr_history_logs_the_jax_message(tmp_path):
    jexp, pexp = _experiments()
    for cls, exp, name in ((Journal, pexp, "port"), (JaxJournal, jexp, "jax")):
        j = cls(exp, save_dir=str(tmp_path / name))
        j.plot_psnr_ssim([])
        j.plot_loss([])
        j.done()
    for name in ("port", "jax"):
        assert (tmp_path / name / "log.txt").read_text() == \
            "No evaluation logs available; skipping PSNR/SSIM plot\n"
        assert not list((tmp_path / name).glob("*.pdf"))
