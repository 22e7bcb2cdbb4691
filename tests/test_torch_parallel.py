"""The port's device mesh without a process group (the layout, the tp rules,
the shard / join round trip, the batch split and its refusals) against the
JAX package's mesh on its 8 CPU devices, and the ranks' launcher's
failures."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from adsr_tpu.core.config import MeshConfig as JaxMesh
from adsr_tpu.core.mesh import make_mesh as jax_make_mesh
from adsr_tpu.parallel.sharding import param_shardings as jax_param_shardings

from adsr_tpu_torch.core.config import (DataConfig, DRCTModelConfig,
                                        Experiment, MeshConfig, OptimConfig,
                                        drct_experiment)
from adsr_tpu_torch.core.mesh import (Mesh, ShardedCall, data_axes,
                                      mesh_layout, n_data, rank_coords,
                                      shard_batch, shard_rows)
from adsr_tpu_torch.eval.evaluate import _forward_split
from adsr_tpu_torch.models.drct import DRCT
from adsr_tpu_torch.parallel.launch import run_ranks
from adsr_tpu_torch.parallel.sharding import (Split, join_tensors,
                                              param_shardings, shard_tensor)
from adsr_tpu_torch.train import trainer as ptrainer

import torch_parallel_ranks as ranks
from torch_port_util import jax_params, port_state_dict

LAYOUTS = [  # (dcn, dp, tp) as MeshConfig fields, over the 8 devices
    dict(dp=-1, tp=1), dict(dp=4, tp=2), dict(dp=3, tp=2),
    dict(dcn=2, dp=4, tp=1), dict(dcn=2, dp=-1, tp=2), dict(dcn=3, dp=2, tp=1),
    dict(dp=-1, tp=4), dict(dcn=2, dp=2, tp=2)]


@pytest.mark.parametrize("kw", LAYOUTS, ids=str)
def test_mesh_layout_matches_jax(kw):
    """The shapes and errors of tests/test_parallel.py:34-49, and each
    rank's coordinates are its device's place in the JAX mesh (tp
    innermost)."""
    try:
        jm = jax_make_mesh(JaxMesh(**kw))
    except ValueError:
        with pytest.raises(ValueError, match="does not cover 8 devices"):
            mesh_layout(MeshConfig(**kw), 8)
        return
    layout = mesh_layout(MeshConfig(**kw), 8)
    got = {a: n for a, n in layout.items() if a != "dcn" or n > 1}
    assert got == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices).reshape(
        layout["dcn"], layout["dp"], layout["tp"])
    for rank in range(8):
        c = rank_coords(layout, rank)
        assert ids[c["dcn"], c["dp"], c["tp"]] == jax.devices()[rank].id
        mesh = Mesh(layout, rank, torch.device("cpu"), "gloo")
        assert mesh.coords == c and mesh.shape == got
        assert data_axes(mesh) == tuple(a for a in ("dcn", "dp") if a in got)
        assert n_data(mesh) == layout["dcn"] * layout["dp"]
        assert mesh.data_index * layout["tp"] + mesh.tp_index == rank


def _flagship_state_dict():
    with torch.device("meta"):
        model = DRCT(drct_experiment("grid", 128, 4).model)
    return model.state_dict()


def test_param_shardings_at_tp2():
    """qkv (by heads, with its bias-table columns) and fc1 column-parallel,
    proj and fc2 row-parallel with replicated biases, everything else
    replicated; at embed 180 (heads 6/4/2/6/4) every block splits."""
    sd = _flagship_state_dict()
    specs = param_shardings(sd, 2)
    split = {k for k, v in specs.items() if v is not None}
    for layer in range(12):
        for k in range(1, 6):
            p = f"layers.{layer}.swin{k}."
            assert specs[p + "attn.qkv.weight"] == Split(0, 3)
            assert specs[p + "attn.qkv.bias"] == Split(0, 3)
            assert specs[p + "attn.relative_position_bias_table"] == Split(1)
            assert specs[p + "attn.proj.weight"] == Split(1)
            assert specs[p + "mlp.fc1.weight"] == specs[p + "mlp.fc1.bias"] \
                == Split(0)
            assert specs[p + "mlp.fc2.weight"] == Split(1)
            for rep in ("attn.proj.bias", "mlp.fc2.bias", "norm1.weight",
                        "norm2.bias"):
                assert specs[p + rep] is None
    assert len(split) == 12 * 5 * 7
    assert all(v is None for k, v in specs.items() if "conv" in k
               or "adjust" in k or k.startswith(("norm.", "patch_embed")))
    assert all(v is None for v in param_shardings(sd, 1).values())


def test_param_shardings_leave_non_dividing_blocks_replicated():
    """embed 12, heads 3, gc 4: heads 3/2/1/3/2, so at tp = 2 only blocks 2
    and 5 split their attention (the JAX ``% tp == 0`` checks); every MLP
    (hidden 24/32/40/24/28) splits. The JAX rules split the same MLPs."""
    sd = port_state_dict("fixup")
    specs = param_shardings(sd, 2)
    for k, heads in zip(range(1, 6), (3, 2, 1, 3, 2)):
        p = f"layers.0.swin{k}."
        assert sd[p + "attn.relative_position_bias_table"].shape[1] == heads
        want = Split(0, 3) if heads % 2 == 0 else None
        assert specs[p + "attn.qkv.weight"] == want
        assert specs[p + "mlp.fc1.weight"] == Split(0)
    jcfg, _, params = jax_params("fixup")
    mesh = jax_make_mesh(JaxMesh(dp=4, tp=2))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(
                jax_param_shardings(params, mesh))[0]}
    for k in range(1, 6):
        jax_split = flat[f"rdgs/rdg/swin{k}/mlp/fc1/kernel"] != P()
        assert jax_split == (specs[f"layers.0.swin{k}.mlp.fc1.weight"]
                             is not None)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_and_join_round_trip(tp):
    """Every split parameter's pieces join back to it bitwise, each piece a
    tp-th of the split dim."""
    sd = port_state_dict("fixup")
    specs = {k: v for k, v in param_shardings(sd, tp).items() if v}
    assert specs
    for k, spec in specs.items():
        pieces = [shard_tensor(sd[k], spec, tp, i) for i in range(tp)]
        assert all(p.shape[spec.dim] * tp == sd[k].shape[spec.dim]
                   for p in pieces)
        assert torch.equal(join_tensors(pieces, spec), sd[k]), k


def test_qkv_shard_holds_q_k_v_of_its_heads():
    c, nh, tp = 16, 4, 2
    w = torch.arange(3 * c * c, dtype=torch.float32).reshape(3 * c, c)
    hd = c // nh
    for i in range(tp):
        piece = shard_tensor(w, Split(0, 3), tp, i)
        heads = range(i * nh // tp, (i + 1) * nh // tp)
        rows = [s * c + h * hd + j for s in range(3) for h in heads
                for j in range(hd)]
        assert torch.equal(piece, w[rows])


def _mesh(dp, rank, tp=1, dcn=1):
    return Mesh({"dcn": dcn, "dp": dp, "tp": tp}, rank, torch.device("cpu"),
                "gloo")


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 1), (2, 2)])
def test_shard_batch_gives_each_data_rank_its_rows(dp, tp):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    lrs = [torch.from_numpy(x), torch.from_numpy(x * 2)]
    parts = {}
    for rank in range(dp * tp):
        m = _mesh(dp, rank, tp)
        parts.setdefault(m.data_index, []).append(shard_rows(m, x))
        got = shard_batch(m, lrs)
        assert torch.equal(got[1], lrs[1][m.data_index * 8 // dp:
                                          (m.data_index + 1) * 8 // dp])
    for same in parts.values():          # the tp ranks of a data index
        assert all(np.array_equal(p, same[0]) for p in same)
    np.testing.assert_array_equal(
        np.concatenate([parts[i][0] for i in range(dp)]), x)


def test_a_batch_that_does_not_divide_raises():
    m = _mesh(3, 0)
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(m, np.zeros((4, 2)))
    with pytest.raises(ValueError, match="does not divide"):
        ShardedCall(lambda x: x, m)(torch.zeros(4, 2))
    cfg = DRCTModelConfig(upscale=2, img_size=8, window_size=4, embed_dim=12,
                          num_layers=1, num_heads=2, gc=4)
    exp = Experiment(model=cfg, data=DataConfig(resolution=16, patch_size=16,
                                                scale=(2,), batch_size=4),
                     optim=OptimConfig(), save="/tmp/t", precision="fp32")
    with pytest.raises(ValueError, match="data-axis product 3"):
        ptrainer.make_train_step(exp, "cpu", mesh=m)
    lr = np.zeros((5, 8, 8, 1), np.float32)
    with pytest.raises(ValueError, match="does not divide"):
        _forward_split(lambda x: x, exp, lr, lr, 4, m)


def test_run_ranks_raises_a_rank_error():
    with pytest.raises(Exception, match="rank one failed"):
        run_ranks(ranks.fail_rank, 2, ["cpu", "cpu"], None, "rank one failed",
                  timeout=120)


def test_run_ranks_ends_ranks_that_hang():
    with pytest.raises(TimeoutError, match="did not finish"):
        run_ranks(ranks.sleep_rank, 2, ["cpu", "cpu"], None, 600.0,
                  timeout=10)
