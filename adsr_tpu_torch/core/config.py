"""Typed, frozen experiment configuration (the DRCT serving slice).

A field-for-field copy of the JAX package's config dataclasses that the DRCT
path needs, kept here so the port imports nothing of ``adsr_tpu``. The
derivation rules are the reference's (reference src/main.py:243-294, 414-448):

- DRCT ``img_size = resolution // scale``, ``window_size = img_size // 4``;
- channel rule: mvtec carpet -> RGB(3), anything else -> gray(1);
- mvtec ``test_every = 256 // batch_size``;
- data/save path conventions.
"""

from __future__ import annotations

import dataclasses
import datetime
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DRCTModelConfig:
    """DRCT Swin-style transformer SR network (reference src/drct.py:716-898)."""
    model_name: str = "drct"
    upscale: int = 4
    img_size: int = 32           # LR input size
    window_size: int = 8         # img_size // 4
    in_chans: int = 1
    embed_dim: int = 180
    num_layers: int = 12         # number of RDGs (len(depths) in the reference)
    num_heads: int = 6
    mlp_ratio: float = 2.0
    gc: int = 32                 # dense growth channels inside an RDG
    num_feat: int = 64           # pre-upsample feature width
    img_range: float = 1.0
    rgb_range: float = 255.0
    qkv_bias: bool = True
    ape: bool = False
    # the JAX package compiles the RDGs as one scanned body; kept for
    # field-for-field parity of the config (the port always loops)
    scan_layers: bool = True
    gelu_approx: bool = False
    remat: bool = True
    remat_policy: str = "full"

    @property
    def scale(self) -> Tuple[int, ...]:
        return (self.upscale,)

    @property
    def n_colors(self) -> int:
        return self.in_chans


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "mvtec"
    classe: str = "grid"
    data_dir: str = "data/mvtec_128/grid/train/good"
    data_root: str = "data/mvtec_128"
    data_test: str = ""
    resolution: int = 128        # HR image size
    patch_size: int = 128        # training crop size (== resolution by default)
    scale: Tuple[int, ...] = (2, 4)
    n_colors: int = 1
    rgb_range: float = 255.0
    batch_size: int = 4
    test_every: int = 64         # batches per epoch (epoch len = test_every*batch)
    no_augment: bool = False


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    eta_min: float = 1e-7
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    epochs: int = 10
    loss: str = "1*L1"
    dual_weight: float = 0.1
    skip_threshold: float = 0.0


@dataclass(frozen=True)
class MeshConfig:
    """Device layout: (dcn x) dp x tp; -1 means all devices on dp."""
    dp: int = -1
    tp: int = 1
    dcn: int = 1


@dataclass(frozen=True)
class Experiment:
    model: DRCTModelConfig
    data: DataConfig
    optim: OptimConfig = OptimConfig()
    mesh: MeshConfig = MeshConfig()
    save: str = "./workspace/experiment/run"
    seed: int = 1
    precision: str = "bf16"      # 'bf16' | 'fp32'
    print_every: int = 64
    save_results: bool = True
    test_only: bool = False
    pre_train: str = "."
    pre_train_dual: str = "."
    ckpt_every: int = 1

    def to_flat_dict(self) -> Dict[str, Any]:
        """Flatten to the reference's config.txt key set where names overlap."""
        out: Dict[str, Any] = {}
        for section in ("model", "data", "optim", "mesh"):
            cfg = getattr(self, section)
            for f in dataclasses.fields(cfg):
                out[f.name] = getattr(cfg, f.name)
        for f in dataclasses.fields(self):
            if f.name not in ("model", "data", "optim", "mesh"):
                out[f.name] = getattr(self, f.name)
        out["model_name"] = self.model.model_name
        out["dataset"] = self.data.dataset
        out["classe"] = self.data.classe
        out["patch_size"] = self.data.patch_size
        out["scale"] = list(self.data.scale)
        if isinstance(self.model, DRCTModelConfig):
            out["upscale"] = self.model.upscale
        return out


def _dataset_paths(dataset: str, classe: str, resolution: int, data_root: str,
                   save_dir: str, model_name: str, run_tag: Optional[str]
                   ) -> Tuple[str, str, str]:
    """Data/save path conventions (reference main.py:423-435)."""
    tag = run_tag if run_tag is not None else datetime.datetime.now().strftime("%H:%M:%S")
    if dataset == "mvtec":
        root = data_root if data_root != "auto" else f"data/mvtec_{resolution}"
        data_dir = f"{root}/{classe}/train/good"
    elif dataset in ("gkd", "gkd_large"):
        root = data_root if data_root != "auto" else f"workspace/{dataset}"
        data_dir = f"{root}/{classe}/train/HR_{resolution}"
    else:
        raise ValueError(f"Unknown dataset: {dataset}")
    save = (f"{save_dir}/{model_name}/"
            f"{'mvtec' if dataset == 'mvtec' else dataset}_{classe}_"
            f"{resolution}_X{{scale}}{tag}/")
    return root, data_dir, save


def _mvtec_cadence(classe: str, batch_size: int) -> int:
    dataset_length = 256  # reference main.py:440
    return max(1, dataset_length // batch_size)


def drct_experiment(classe: str = "grid", resolution: int = 128, scale: int = 4,
                    epochs: int = 2, batch_size: int = 4, lr: float = 1e-4,
                    data_root: str = "auto", save_dir: str = "./workspace/experiment",
                    no_augment: bool = False, loss: str = "1*L1",
                    pre_train: str = ".", seed: int = 1,
                    mesh: MeshConfig = MeshConfig(), precision: str = "bf16",
                    run_tag: Optional[str] = None,
                    embed_dim: int = 180, num_layers: int = 12,
                    num_heads: int = 6, gc: int = 32,
                    dataset: str = "mvtec",
                    remat_policy: str = "full") -> Experiment:
    n_colors = 3 if (dataset == "mvtec" and classe == "carpet") else 1
    img_size = resolution // scale
    window_size = max(1, img_size // 4)
    root, data_dir, save = _dataset_paths(dataset, classe, resolution,
                                          data_root, save_dir, "drct",
                                          run_tag)
    test_every = _mvtec_cadence(classe, batch_size)
    model = DRCTModelConfig(upscale=scale, img_size=img_size,
                            window_size=window_size, in_chans=n_colors,
                            embed_dim=embed_dim, num_layers=num_layers,
                            num_heads=num_heads, gc=gc,
                            remat_policy=remat_policy)
    data = DataConfig(dataset=dataset, classe=classe, data_dir=data_dir,
                      data_root=root,
                      resolution=resolution, patch_size=resolution,
                      scale=(scale,), n_colors=n_colors, batch_size=batch_size,
                      test_every=test_every, no_augment=no_augment)
    optim = OptimConfig(lr=lr, epochs=epochs, loss=loss)
    return Experiment(model=model, data=data, optim=optim, mesh=mesh,
                      save=save.format(scale=scale), seed=seed,
                      precision=precision, print_every=test_every,
                      pre_train=pre_train)
