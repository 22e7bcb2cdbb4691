"""The port's mesh with its ranks running (spawned on the CPU over gloo by
``parallel/launch.py``): the data-parallel DRCT and DRN steps against the
JAX package's ``ParallelTrainer`` at dp = 2 on its CPU devices and against
the port's own single-process step, the dcn layout against the flat one,
the tensor-parallel eager step, batch-parallel evaluation and serving, the
``Trainer`` on a mesh and ``cli.main --dp 2``. f32, tiny widths, drop path
off (one RDG: every rate is 0)."""

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adsr_tpu.core.config import DataConfig as JaxData
from adsr_tpu.core.config import Experiment as JaxExperiment
from adsr_tpu.core.config import MeshConfig as JaxMesh
from adsr_tpu.core.config import OptimConfig as JaxOptim
from adsr_tpu.core.mesh import make_mesh as jax_make_mesh
from adsr_tpu.io.torch_convert import convert_drct, stack_scan_layers
from adsr_tpu.parallel.sharding import ParallelTrainer as JaxParallelTrainer

from adsr_tpu_torch.core.config import (DataConfig, Experiment, MeshConfig,
                                        OptimConfig)
from adsr_tpu_torch.core.mesh import mesh_layout
from adsr_tpu_torch.io.convert import (drct_state_dict_from_jax,
                                       drn_duals_from_jax,
                                       drn_state_dict_from_jax)
from adsr_tpu_torch.io.journal import load_state_dict
from adsr_tpu_torch.models.factory import make_model
from adsr_tpu_torch.parallel.launch import run_ranks
from adsr_tpu_torch.train import trainer as ptrainer

import torch_parallel_ranks as ranks
from test_torch_cli import TINY, _split
from torch_port_util import drn_jax_params, jax_params, port_state_dict

REPO = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-3, 1e-3     # against JAX: the f32 forward tolerance
TIMEOUT = 240
CPU2 = ["cpu", "cpu"]


def drct_cfg(jax_side: bool):
    """tests/test_parallel.py:27-29's DRCT: embed 16, heads 2, window 4,
    one RDG."""
    from adsr_tpu.core.config import DRCTModelConfig as JaxDRCT
    from adsr_tpu_torch.core.config import DRCTModelConfig as PortDRCT
    kw = dict(upscale=2, img_size=8, window_size=4, in_chans=1, embed_dim=16,
              num_layers=1, num_heads=2, gc=4)
    return (JaxDRCT if jax_side else PortDRCT)(**kw)


def experiments(jcfg, pcfg, scales, batch, hr=16):
    data = dict(resolution=hr, patch_size=hr, scale=scales, n_colors=1,
                batch_size=batch, test_every=2)
    optim = dict(lr=ranks.LR_RATE, epochs=2)
    jexp = JaxExperiment(model=jcfg, data=JaxData(**data),
                         optim=JaxOptim(**optim), mesh=JaxMesh(dp=2, tp=1),
                         save="/tmp/t", precision="fp32")
    pexp = Experiment(model=pcfg, data=DataConfig(**data),
                      optim=OptimConfig(**optim), mesh=MeshConfig(dp=2),
                      save="/tmp/t", precision="fp32", print_every=1)
    return jexp, pexp


def batch(scales, n, hr=16, seed=3):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, hr, hr, 1) * 255).astype(np.float32)
    lrs = [x.reshape(n, hr // s, s, hr // s, s, 1).mean(axis=(2, 4))
           for s in sorted(scales, reverse=True)]
    return lrs, x


def jax_dp2_step(jexp, lrs, hr):
    """JAX ParallelTrainer at dp = 2 on two CPU devices: its initial
    params (a host copy: the step donates them), its params after one
    step and its metrics."""
    mesh = jax_make_mesh(JaxMesh(dp=2, tp=1), devices=jax.devices()[:2])
    tr = JaxParallelTrainer(jexp, mesh, key=jax.random.key(0))
    params0 = jax.tree_util.tree_map(np.array, tr.state.params)
    m = tr.step([jnp.asarray(x) for x in lrs], jnp.asarray(hr),
                ranks.LR_RATE, jax.random.key(1))
    after = jax.tree_util.tree_map(np.array, tr.state.params)
    return params0, after, {k: float(v) for k, v in m.items()}


def single_step(pexp, primal, lrs, hr, duals=None):
    """The port's single-process step at the global batch."""
    exp = dataclasses.replace(pexp, mesh=MeshConfig())
    bundle = ptrainer.make_train_step(exp, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(primal)
    if duals is not None:
        for d, sd in zip(state.duals, duals):
            d.load_state_dict(sd)
    state, m = bundle.step(state, [torch.from_numpy(x) for x in lrs],
                           torch.from_numpy(hr), ranks.LR_RATE,
                           torch.Generator().manual_seed(1))
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return state, {k: float(v) for k, v in m.items()}, grads


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


def test_drct_dp2_step_matches_jax_and_the_single_step():
    """dp = 2 and dcn = 2 x dp = 1 in one world of two ranks: each matches
    the JAX ParallelTrainer at dp = 2 (loss, params after the step) and the
    port's single-process step at the global batch (loss, the averaged
    gradients); dcn = 2 equals flat dp = 2 bitwise (as
    test_drct_dcn_dp_step)."""
    jexp, pexp = experiments(drct_cfg(True), drct_cfg(False), (2,), 8)
    lrs, hr = batch((2,), 8)
    params0, jafter, jm = jax_dp2_step(jexp, lrs, hr)
    primal = drct_state_dict_from_jax(params0["primal"], pexp.model)
    out = run_ranks(ranks.step_rank, 2, CPU2, None, 2,
                    [MeshConfig(dp=2), MeshConfig(dcn=2, dp=1)], pexp,
                    {k: v.numpy() for k, v in primal.items()}, None, lrs, hr,
                    timeout=TIMEOUT)
    flat, dcn = out[0]
    want = drct_state_dict_from_jax(jafter["primal"], pexp.model)
    for rec in (flat, dcn):
        assert rec["metrics"]["total"] == pytest.approx(jm["total"],
                                                        rel=RTOL, abs=ATOL)
        assert_close(rec["params"], want)
    state, sm, sgrads = single_step(pexp, primal, lrs, hr)
    assert flat["metrics"]["total"] == pytest.approx(sm["total"], rel=1e-5)
    assert_close(flat["grads"], sgrads, atol=1e-6, rtol=1e-4)
    assert_close(flat["params"], state.model.state_dict())
    for k in flat["params"]:          # the layouts are the same program
        assert torch.equal(flat["params"][k], dcn["params"][k]), k
        assert torch.equal(out[1][0]["params"][k], flat["params"][k]), k
    assert flat["metrics"] == dcn["metrics"] == out[1][0]["metrics"]
    assert dcn["coords"] == {"dcn": 0, "dp": 0, "tp": 0}
    assert out[1][1]["coords"] == {"dcn": 1, "dp": 0, "tp": 0}


def test_drn_dp2_step_matches_jax():
    """DRN-L (scales 2, 4) at dp = 2 against the JAX ParallelTrainer: the
    loss terms and the primal and dual parameters after one step."""
    jcfg, pcfg, _, _ = drn_jax_params((2, 4))
    jexp, pexp = experiments(jcfg, pcfg, (2, 4), 4, hr=32)
    lrs, hr = batch((2, 4), 4, hr=32)
    params0, jafter, jm = jax_dp2_step(jexp, lrs, hr)
    primal = drn_state_dict_from_jax(params0["primal"], pcfg)
    duals = drn_duals_from_jax(params0["duals"], pcfg)
    out = run_ranks(ranks.step_rank, 2, CPU2, None, 2, [MeshConfig(dp=2)],
                    pexp, primal, duals, lrs, hr, timeout=TIMEOUT)
    rec = out[0][0]
    for k in ("total", "primary", "dual"):
        assert rec["metrics"][k] == pytest.approx(jm[k], rel=RTOL, abs=ATOL)
    assert_close(rec["params"], drn_state_dict_from_jax(jafter["primal"],
                                                        pcfg))
    for got, want in zip(rec["duals"], drn_duals_from_jax(jafter["duals"],
                                                          pcfg)):
        assert_close(got, want)
    assert rec["params"].keys() == out[1][0]["params"].keys()
    for k, v in rec["params"].items():          # both ranks took one step
        assert torch.equal(v, out[1][0]["params"][k]), k


@pytest.mark.parametrize("world,mesh", [
    (2, MeshConfig(dp=1, tp=2)), (4, MeshConfig(dp=2, tp=2))],
    ids=["tp2", "dp2xtp2"])
def test_eager_tp_step_matches_the_single_step(world, mesh):
    """The eager model with its attention (blocks 2 and 5: heads 3/2/1/3/2)
    and every MLP split over two tp ranks: the loss, every gradient gathered
    to the full layout, and the parameters after one step against the
    single-process step; each rank's shard and gather round trip is
    bitwise."""
    jcfg, pcfg, _ = jax_params("fixup")
    _, pexp = experiments(jcfg, pcfg, (2,), 4)
    pexp = dataclasses.replace(pexp, mesh=mesh)
    primal = port_state_dict("fixup")
    lrs, hr = batch((2,), 4)
    out = run_ranks(ranks.step_rank, world, ["cpu"] * world, None, world,
                    [mesh], pexp, {k: v.numpy() for k, v in primal.items()},
                    None, lrs, hr, timeout=TIMEOUT)
    state, sm, sgrads = single_step(pexp, primal, lrs, hr)
    for per_rank in out:
        rec = per_rank[0]
        assert rec["roundtrip"]
        # qkv weight and bias, proj weight, bias table of blocks 2 and 5;
        # fc1 weight and bias, fc2 weight of every block
        assert sum(s is not None for s in rec["specs"].values()) == \
            2 * 4 + 5 * 3
        assert rec["metrics"]["total"] == pytest.approx(sm["total"],
                                                        rel=1e-5)
        assert_close(rec["grads"], sgrads, atol=1e-6, rtol=1e-4)
        assert_close(rec["params"], state.model.state_dict())


def _sr_dataset_arrays(n, hr=16, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, hr, hr, 1) * 255).astype(np.float32)
    return x, x.reshape(n, hr // 2, 2, hr // 2, 2, 1).mean(axis=(2, 4))


def test_batch_sharded_forward_matches():
    """``_forward_split`` over dp = 2 on 10 images at batch 8 (a padded
    tail) and ``make_serving_forward(mesh=...)`` equal their unsharded runs
    bitwise (test_batch_sharded_forward_matches)."""
    jcfg, pcfg, _ = jax_params("fixup")
    _, pexp = experiments(jcfg, pcfg, (2,), 8)
    params = port_state_dict("fixup")
    hr, lr = _sr_dataset_arrays(10)
    out = run_ranks(ranks.serve_rank, 2, CPU2, None, 2, pexp,
                    {k: v.numpy() for k, v in params.items()}, lr, hr, 8,
                    timeout=TIMEOUT)
    for rec in out:
        for a, b in zip(rec["sharded"], rec["single"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rec["served"], rec["alone"])
    np.testing.assert_array_equal(out[0]["served"], out[1]["served"])


def _trainer_run(tmp_path, cfg, world, mesh):
    """The Trainer on ``mesh`` over ``world`` ranks and at dp = 1, from
    the same experiment and data: both runs' records and run dirs."""
    _, pexp = experiments(cfg(True), cfg(False), (2,), 4)
    hr, lr = _sr_dataset_arrays(6)
    thr, tlr = _sr_dataset_arrays(3, seed=1)
    train = (hr, [lr], (2,))
    test = (thr, [tlr], (2,))
    exp_n = dataclasses.replace(pexp, save=str(tmp_path / "mesh"),
                                mesh=mesh)
    out = run_ranks(ranks.trainer_rank, world, ["cpu"] * world, None, world,
                    exp_n, train, test, timeout=TIMEOUT)
    exp1 = dataclasses.replace(pexp, save=str(tmp_path / "dp1"),
                               mesh=MeshConfig())
    threads = torch.get_num_threads()
    try:
        one = ranks.trainer_rank(0, 1, exp1, train, test)
    finally:
        torch.set_num_threads(threads)
    assert one["layout"] is None
    for rec in out:
        assert rec["resumed_epoch"] == 1 and rec["resumed_step"] == 2
        assert rec["resumed_equal"] and rec["resumed_opt_equal"]
        assert rec["mean"]["total"] == pytest.approx(one["mean"]["total"],
                                                     rel=1e-5)
        assert rec["psnr_ssim"] == pytest.approx(one["psnr_ssim"], rel=1e-4)
        assert_close(rec["params"], one["params"])

    def layout(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert layout(tmp_path / "mesh") == layout(tmp_path / "dp1")
    log = (tmp_path / "mesh" / "log.txt").read_text()
    assert log.count("[Epoch 1]") == 1 and log.count("PSNR:") == 1
    return exp_n, out


def test_trainer_on_a_dp2_mesh(tmp_path):
    """A Trainer on a MeshConfig(dp=2) mesh: one epoch and ``test`` write
    the run-dir layout of dp = 1 from rank 0 alone, match the dp = 1 run,
    and a new Trainer resumes from the checkpoint bitwise."""
    _, out = _trainer_run(tmp_path, drct_cfg, 2, MeshConfig(dp=2))
    assert out[0]["layout"] == {"dcn": 1, "dp": 2, "tp": 1}


def fixup_cfg(jax_side: bool):
    """The heads 3/2/1/3/2 model: blocks 2 and 5 split their attention at
    tp = 2, every block its MLP."""
    jcfg, pcfg, _ = jax_params("fixup")
    return jcfg if jax_side else pcfg


@pytest.mark.parametrize("world,mesh", [
    (2, MeshConfig(dp=1, tp=2)), (4, MeshConfig(dp=2, tp=2))],
    ids=["tp2", "dp2xtp2"])
def test_trainer_on_a_tp_mesh(tmp_path, world, mesh):
    """The Trainer with its model split over two tp ranks: the state it
    checkpoints is the full layout (a whole model and Adam gathered from
    the shards), a resume splits it back bitwise on every rank, its test
    scores the gathered model, and the run dir's ``model_latest.pt`` loads
    into the one-card model and equals the dp = 1 run's."""
    exp, out = _trainer_run(tmp_path, fixup_cfg, world, mesh)
    assert all(rec["split"] for rec in out)
    assert out[0]["layout"] == mesh_layout(mesh, world)
    sd = load_state_dict(tmp_path / "mesh" / "model" / "model_latest.pt")
    model = make_model(exp.model, device="cpu")
    model.load_state_dict(sd)
    assert_close(sd, out[0]["params"], atol=0, rtol=0)
    # the checkpoint's Adam is the one-card run's, moment by moment: the
    # shards went back to the parameters they came from
    state, one = (torch.load(tmp_path / d / "model" / "train_state_latest.pt",
                             weights_only=False) for d in ("mesh", "dp1"))
    assert state["step"] == one["step"] == 2
    names = [n for n, _ in model.named_parameters()]
    got, want = state["optimizer"]["state"], one["optimizer"]["state"]
    assert got.keys() == want.keys() == set(range(len(names)))
    for i, name in enumerate(names):
        assert got[i]["exp_avg"].shape == model.get_parameter(name).shape
        assert_close({k: got[i][k] for k in ("exp_avg", "exp_avg_sq")},
                     {k: want[i][k] for k in ("exp_avg", "exp_avg_sq")},
                     atol=1e-6, rtol=1e-4)


def _cli_data(tmp_path):
    root = tmp_path / "data"
    rng = np.random.RandomState(0)
    _split(root / "grid" / "train" / "good", 4, 32, rng)
    _split(root / "grid" / "val" / "good", 2, 32, rng)
    return root


def _cli(tmp_path, root, *flags):
    """``cli.main`` on the tiny DRCT at batch 4 on the CPU, as a command."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "adsr_tpu_torch.cli.main", *TINY,
           "--batch-size", "4", "--data-root", str(root),
           "--save-dir", str(tmp_path / "runs"), "--device", "cpu",
           "--precision", "fp32", *flags]
    return cmd, env


def _cli_run_dir_loads(run_dir, mesh_flags):
    """The run dir's ``model_latest.pt`` loads into the single-card model
    and into the JAX converter; returns the build's experiment."""
    log = (run_dir / "log.txt").read_text()
    assert "x 2 ranks" in log and "[Epoch 1]" in log and "PSNR:" in log
    assert log.count("[Epoch 1]") == 1
    sd = load_state_dict(run_dir / "model" / "model_latest.pt")
    from adsr_tpu_torch.cli.main import build_experiment, parse_args
    exp = build_experiment(parse_args(TINY + mesh_flags + ["--batch-size",
                                                           "4"]))
    make_model(exp.model, device="cpu").load_state_dict(sd)
    jparams = stack_scan_layers(convert_drct(
        {k: v.numpy() for k, v in sd.items()}), exp.model.num_layers)
    assert jparams["rdgs"]["rdg"]["swin1"]["attn"]["qkv"]["kernel"].shape \
        == (1, 12, 36)
    assert (run_dir / "model" / "train_state_latest.pt").is_file()


def test_train_cli_dp2_on_the_cpu(tmp_path):
    """``python -m adsr_tpu_torch.cli.main --dp 2 --device cpu`` spawns two
    gloo ranks and trains one epoch into a run dir whose checkpoint loads
    into the single-card model and into the JAX converter."""
    root = _cli_data(tmp_path)
    cmd, env = _cli(tmp_path, root, "--epochs", "1", "--run-tag", "dp2",
                    "--dp", "2")
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    _cli_run_dir_loads(next((tmp_path / "runs").rglob("log.txt")).parent,
                       ["--dp", "2"])


def test_train_cli_tp2_on_the_cpu(tmp_path):
    """``--tp 2``: two gloo ranks split the tiny model's attention heads
    and MLP in every block; the run dir is in the full layout and loads on
    one card."""
    root = _cli_data(tmp_path)
    cmd, env = _cli(tmp_path, root, "--epochs", "1", "--run-tag", "tp2",
                    "--tp", "2")
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    run_dir = next((tmp_path / "runs").rglob("log.txt")).parent
    assert "'tp': 2" in (run_dir / "log.txt").read_text()
    _cli_run_dir_loads(run_dir, ["--tp", "2"])


def test_train_cli_dp2_stops_resumable_on_sigterm(tmp_path):
    """SIGTERM to ``cli.main --dp 2`` reaches both ranks: they finish the
    epoch, write ``train_state_latest.pt`` and exit 0; ``--resume`` goes
    on from that epoch."""
    root = _cli_data(tmp_path)
    cmd, env = _cli(tmp_path, root, "--epochs", "100000", "--run-tag", "sig",
                    "--dp", "2", "--ckpt-every", "0")
    run_dir = tmp_path / "runs" / "drct" / "mvtec_grid_32_X4sig"
    metrics = run_dir / "metrics.jsonl"          # a line an epoch
    with open(tmp_path / "out.txt", "w") as out:
        proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + TIMEOUT
            while not (metrics.is_file() and metrics.read_text()):
                assert proc.poll() is None, \
                    (tmp_path / "out.txt").read_text()[-3000:]
                assert time.monotonic() < deadline, "no epoch in time"
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    err = (tmp_path / "out.txt").read_text()
    assert proc.returncode == 0, err[-3000:]
    log = run_dir / "log.txt"
    assert "Preempted: state saved" in log.read_text()
    state = run_dir / "model" / "train_state_latest.pt"
    epoch = torch.load(state, weights_only=False)["epoch"]
    assert 1 <= epoch < 100000
    cmd, env = _cli(tmp_path, root, "--epochs", str(epoch + 1), "--run-tag",
                    "sig", "--dp", "2", "--resume")
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    text = log.read_text()
    assert f"(epoch {epoch})" in text and f"[Epoch {epoch + 1}]" in text
    assert torch.load(state, weights_only=False)["epoch"] == epoch + 1
