"""The port's config copy equals the JAX package's, field by field."""

import dataclasses

import pytest

from adsr_tpu.core import config as jcfg

from adsr_tpu_torch.core import config as pcfg


@pytest.mark.parametrize("cls", ["DRCTModelConfig", "DataConfig",
                                 "OptimConfig", "MeshConfig", "Experiment"])
def test_same_fields_and_defaults(cls):
    ours, theirs = getattr(pcfg, cls), getattr(jcfg, cls)
    ours_f = [(f.name, f.default) for f in dataclasses.fields(ours)]
    theirs_f = [(f.name, f.default) for f in dataclasses.fields(theirs)]
    if cls == "Experiment":     # defaults that are dataclass instances
        ours_f = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d)
                   else d) for n, d in ours_f]
        theirs_f = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d)
                     else d) for n, d in theirs_f]
    assert ours_f == theirs_f


@pytest.mark.parametrize("classe,resolution,scale,precision", [
    ("grid", 128, 4, "bf16"), ("carpet", 256, 8, "fp32")])
def test_drct_experiment_equal(classe, resolution, scale, precision):
    ours = pcfg.drct_experiment(classe, resolution, scale, precision=precision,
                                run_tag="tag")
    theirs = jcfg.drct_experiment(classe, resolution, scale,
                                  precision=precision, run_tag="tag")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_flat_dict() == theirs.to_flat_dict()
    assert ours.model.scale == theirs.model.scale
    assert ours.model.n_colors == theirs.model.n_colors


def test_flagship_geometry():
    m = pcfg.drct_experiment("grid", 128, 4, run_tag="t").model
    assert (m.img_size, m.window_size, m.embed_dim, m.num_layers, m.in_chans,
            m.gc, m.num_heads) == (32, 8, 180, 12, 1, 32, 6)
