"""Training engine: one train step plus a thin epoch driver, and the serving
forward bound to fixed params (the port of ``adsr_tpu/train/trainer.py``).

Reproduced semantics (trainer.py:100-113, 148-351, 354-398, 518-704):
- torch-style Adam: the L2 weight decay enters the gradient before the
  moments (``torch.optim.Adam``'s ``weight_decay``, the optax chain of
  ``add_decayed_weights`` then ``scale_by_adam``); the learning rate is set
  per step;
- CosineAnnealingLR stepped per epoch:
  ``lr(e) = eta_min + (lr0 - eta_min) * (1 + cos(pi*e/epochs)) / 2``;
- the opt-in loss-spike skip: a step whose loss is not below
  ``skip_threshold * error_last`` leaves the params and the Adam moments
  untouched;
- per-epoch loss log, PSNR/SSIM eval through quantised SR
  (``psnr_shave4`` / ``ssim_shave4``) with best tracking, terminate on epochs.

DRCT: on the card the step runs the fused training forward and backward
(``kernels/fused_rdg_train.py``: every RDG on the hand-written kernels, the
head, tail, loss and Adam in PyTorch), bf16 only (fp32 training on the
card is refused: :func:`check_training_precision`). On the CPU it runs the
eager f32 model under autograd (the plain version of the same function).
DRN-L (``models/drn.py``, convolutions in cuDNN / PyTorch, as the JAX
package computes them in XLA) runs the same eager module on both devices,
in bf16 (convs on bf16 inputs and weights, f32 parameters and loss) or in
f32 with TF32 off, with its dual-regression loss (trainer.py:231-251):
primary = L(sr[-1], hr) + sum_i L(sr[i-1-n], lrs[i-n]), dual = sum_i
L(dual_i(sr[i-n_d]), lrs[i]), total = primary + dual_weight * dual, and
one Adam over the primal and dual parameters. The init and drop-path
streams are separate generators seeded from ``exp.seed``, in the role of
the JAX package's ``prng.stream(key, "init" | "dropout")``: the same
distributions, not the same bits. With a ``Journal`` (``io/journal.py``)
the Trainer logs into the run dir, saves ``model_latest.pt`` /
``model_best.pt`` (and DRN's ``dual_model_*.pt``) at every test and
checkpoints its full state for a true resume; without one it logs with
``print``.

Over a device mesh (``core/mesh.py``, trainer.py:289-330, 522-674): each
data rank runs the step on its ``B / n_data`` rows with the loss built at
the local batch size, then one ``all_reduce`` of a flat gradient bucket
and one of the metrics, both divided by ``n_data``, so every rank takes
the same Adam step and the same loss-spike decision. Every rank draws the
drop-path multipliers of the whole batch from the one generator and keeps
its rows, so the draws are the single-card step's. With tp > 1 the step
runs the eager model (f32, TF32 off) with DRCT's attention and MLP split
over the tp ranks (``parallel/tensor.py``), as the JAX package leaves its
fused step for the XLA model there. The Trainer splits its batches and its
test over the data ranks; only the rank given a Journal writes, and
checkpoints keep the full reference layout at any tp.

The serving forwards (``make_serving_forward``, ``make_eval_forward``,
``make_tiled_serving_forward``) take the full-scale SR ``sr[-1]`` of a DRN
and, for DRCT, ``mode``: ``"rdg"`` runs each RDG on kernels (a)-(c),
``"block"`` each Swin block on kernel (g); ``None`` reads ``ADSR_TPU_RDG``
as the JAX package does. They serve in the experiment's precision: bf16,
or fp32 through the f32 instances of kernels (a)-(c) in rdg mode and of
kernel (g) in block mode. On the
card ``make_serving_forward`` and ``make_tiled_serving_forward`` serve
through one CUDA graph per LR shape (``core/graphs.py``), as the JAX
versions jit theirs; ``graphs=False`` launches every kernel from Python on
every call. ``make_eval_forward``
takes new params on every call, so it launches. With a ``mesh`` both serve
batch-parallel (``core/mesh.py`` ``ShardedCall``, trainer.py:441-452):
each data rank runs its rows through its own captured call and the SR rows
are gathered in rank order.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.config import (DRCTModelConfig, DRNModelConfig,
                                        Experiment)
from adsr_tpu_torch.core.device import (compute_dtype, deterministic_f32,
                                        full_f32, resolve_device)
from adsr_tpu_torch.core.graphs import CapturedCall
from adsr_tpu_torch.core.mesh import (Mesh, ShardedCall, gather_rows,
                                      mean_over_data, n_data, shard_batch,
                                      shard_rows)
from adsr_tpu_torch.data.pipeline import EpochSampler, SRDataset
from adsr_tpu_torch.eval.tiled import feather_weights, tiled_sr_forward
from adsr_tpu_torch.io.journal import TRAIN_STATE, Journal, load_train_state
from adsr_tpu_torch.kernels.fused_drct import (fused_drct_apply,
                                               prepack_drct, resolve_mode)
from adsr_tpu_torch.kernels.fused_rdg_train import fused_drct_train_forward
from adsr_tpu_torch.metrics import psnr_shave4, quantize, ssim_shave4
from adsr_tpu_torch.models.drct import drop_path_mults
from adsr_tpu_torch.models.drn import apply_dual, make_dual_models
from adsr_tpu_torch.models.factory import init_sr_params, make_model
from adsr_tpu_torch.parallel.sharding import (gather_optimizer_state,
                                              gather_state_dict,
                                              param_shardings,
                                              shard_optimizer_state,
                                              shard_state_dict)
from adsr_tpu_torch.parallel.tensor import shard_model_
from adsr_tpu_torch.train.losses import make_loss


def check_serving_precision(exp: Experiment, device: torch.device,
                            mode: Optional[str] = None) -> None:
    """DRCT serves bf16 and fp32 on the card in both modes (``mode``, or
    ``ADSR_TPU_RDG`` when None; an unknown one raises ``ValueError``): rdg
    mode on kernels (a)-(c), block mode on kernel (g), each with bf16 and
    f32 instances. The CPU's plain path takes both. DRN-L runs no kernel
    of the port and takes both precisions. Another model raises
    ``NotImplementedError``."""
    if isinstance(exp.model, DRNModelConfig):
        return
    if not isinstance(exp.model, DRCTModelConfig):
        raise NotImplementedError(
            f"the port has no model for {type(exp.model).__name__}")
    resolve_mode(mode)


def check_training_precision(exp: Experiment, device: torch.device) -> None:
    """DRCT trains on the card in bf16 and fp32 at any mesh (kernels (a)-(f)
    have bf16 and f32 instances; at tp > 1 the eager model runs in f32);
    its validation forward serves in rdg mode, which takes both. The CPU's
    eager model trains in both; DRN-L takes both everywhere."""
    check_serving_precision(exp, device, mode="rdg")


def drn_sr(model: torch.nn.Module, exp: Experiment,
           lr: torch.Tensor) -> torch.Tensor:
    """The full-scale SR ``sr[-1]`` of a DRN in the experiment's precision,
    as f32 (trainer.py:393-395)."""
    return model(lr, dtype=compute_dtype(exp.precision))[-1].float()


def _sr_function(exp: Experiment, params: Mapping[str, torch.Tensor],
                 dev: torch.device, mode: Optional[str],
                 size: Optional[int] = None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """LR NHWC -> raw float SR with ``params`` fixed: DRN's eager module
    with ``params`` loaded once, in the working type (every conv casts its
    weights to its input's type anyway, so this is exact and saves a cast
    a weight a call), or DRCT's fused forward packed once at an LR of
    ``size`` x ``size`` (default its ``img_size``)."""
    if isinstance(exp.model, DRNModelConfig):
        model = make_model(exp.model, dev)
        model.load_state_dict(params)
        model.to(compute_dtype(exp.precision)).eval()
        return lambda lr: drn_sr(model, exp, lr)
    size = size or exp.model.img_size
    packed = prepack_drct(params, exp.model, size, size,
                          dtype=compute_dtype(exp.precision), device=dev,
                          mode=mode)
    return lambda lr: fused_drct_apply(packed, exp.model, lr)


def make_serving_forward(exp: Experiment,
                         params: Mapping[str, torch.Tensor],
                         device="cuda", quantize_out: bool = True,
                         mode: Optional[str] = None, graphs: bool = True,
                         mesh: Optional[Mesh] = None):
    """Fixed-params inference: LR batch NHWC float -> SR batch (quantized to
    the 0-255 grid unless ``quantize_out=False``).

    ``params`` is the port's state_dict. For DRCT, packing (weights in the
    working type, the bias gather, the shift masks) runs ONCE here, as the
    JAX version's ``prepack_drct`` does (adsr_tpu/train/trainer.py:400-457),
    and ``mode`` picks ``"rdg"`` or ``"block"`` (``kernels/fused_drct.py``;
    ``None`` reads ``ADSR_TPU_RDG``); a DRN serves its full-scale output
    and ignores ``mode``. On the card the forward runs as one CUDA graph per
    LR shape (the JAX version's jit, trainer.py:447-454); ``graphs=False``
    launches its kernels on every call. ``forward(lr)`` takes a numpy array
    or a tensor on any device. With a ``mesh`` (on the mesh's device) each
    data rank serves its rows of the batch, which must divide by
    ``n_data``, and every rank returns the whole SR batch
    (trainer.py:441-452)."""
    dev = resolve_device(device if mesh is None else mesh.device)
    check_serving_precision(exp, dev, mode)
    sr_of = _sr_function(exp, params, dev, mode)

    @torch.no_grad()
    def forward(lr: torch.Tensor) -> torch.Tensor:
        sr = sr_of(lr)
        return quantize(sr, exp.data.rgb_range) if quantize_out else sr

    call = CapturedCall(forward, dev, capture=graphs)
    return call if mesh is None else ShardedCall(call, mesh)


def make_eval_forward(exp: Experiment, device="cuda",
                      quantize_out: bool = True, mode: Optional[str] = None
                      ) -> Callable[[Mapping[str, torch.Tensor], torch.Tensor],
                                    torch.Tensor]:
    """Inference with params that change between calls (the Trainer's
    eval): ``forward(params, lr)``. DRCT repacks ``params`` and launches
    the serving kernels (trainer.py:354-398); its capture belongs with the
    compiled train step (ROADMAP.md Queue 1 item 2). A DRN loads
    ``params`` into one module and returns ``sr[-1]``."""
    dev = resolve_device(device)
    check_serving_precision(exp, dev, mode)
    if isinstance(exp.model, DRNModelConfig):
        model = make_model(exp.model, dev).eval()

        @torch.no_grad()
        def drn_forward(params: Mapping[str, torch.Tensor],
                        lr) -> torch.Tensor:
            model.load_state_dict(params)
            sr = drn_sr(model, exp, torch.as_tensor(lr, device=dev))
            return quantize(sr, exp.data.rgb_range) if quantize_out else sr

        return drn_forward

    def forward(params: Mapping[str, torch.Tensor], lr) -> torch.Tensor:
        return make_serving_forward(exp, params, dev, quantize_out, mode,
                                    graphs=False)(lr)

    return forward


def make_tiled_serving_forward(exp: Experiment,
                               params: Mapping[str, torch.Tensor],
                               tile: int = 0, overlap: int = 8,
                               quantize_out: bool = True, device="cuda",
                               mode: Optional[str] = None,
                               graphs: bool = True,
                               mesh: Optional[Mesh] = None):
    """Serving forward for LR inputs larger than the model's tile
    (trainer.py:460-515): the LR batch is cut into overlapping ``tile``-sized
    crops, all of them go through one forward (DRCT's packed at the tile
    size) and the SR tiles are feather-blended (``eval/tiled.py``). ``tile``
    defaults to DRCT's ``img_size`` and to 32 for a DRN (trainer.py:479-480).
    Returns ``forward(lr)``: on the card the whole call (crops, forward,
    blend, quantisation) runs as one CUDA graph per LR shape, as the JAX
    version jits it; ``graphs=False`` launches it. With a ``mesh``, batch-
    parallel as :func:`make_serving_forward`."""
    dev = resolve_device(device if mesh is None else mesh.device)
    check_serving_precision(exp, dev, mode)
    cfg = exp.model
    scale = max(exp.data.scale)
    if isinstance(cfg, DRCTModelConfig):
        tile = tile if tile > 0 else cfg.img_size
        win = cfg.window_size
        if tile < win or tile % win != 0:
            raise ValueError(
                f"--tile must be a multiple of the model's window_size "
                f"({win}) and >= it; got tile={tile}. A non-divisible tile "
                "would build truncated window plans/masks.")
    else:
        tile = tile if tile > 0 else 32
    sr_of = _sr_function(exp, params, dev, mode, tile)
    mask = feather_weights(tile, overlap, scale, dev)

    @torch.no_grad()
    def forward(lr: torch.Tensor) -> torch.Tensor:
        sr = tiled_sr_forward(sr_of, lr, tile, overlap, scale, mask)
        return quantize(sr, exp.data.rgb_range) if quantize_out else sr

    call = CapturedCall(forward, dev, capture=graphs)
    return call if mesh is None else ShardedCall(call, mesh)


def cosine_lr(epoch: int, lr0: float, eta_min: float, epochs: int) -> float:
    """CosineAnnealingLR value at (0-based) epoch (trainer.py:76-83)."""
    return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2


def make_optimizer(params, beta1: float, beta2: float, epsilon: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: the weight decay enters the gradient before the
    moments; the step sets the learning rate of every group."""
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2), eps=epsilon,
                            weight_decay=weight_decay)


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    duals: Optional[torch.nn.ModuleList] = None     # DRN's dual models
    # the full state_dict's tp splits (parallel/sharding.py), when the
    # model holds this rank's shards; None when it holds the whole model
    specs: Optional[Dict] = None

    def dual_state_dicts(self) -> Optional[List[Dict[str, torch.Tensor]]]:
        """The dual models' ``state_dict``s (the reference's
        ``dual_model_*.pt`` layout), or None without duals."""
        if self.duals is None:
            return None
        return [d.state_dict() for d in self.duals]


class TrainStepBundle:
    """``step(state, lrs, hr, lr_rate, generator, error_last) -> (state,
    metrics)``, ``init_state(generator) -> TrainState`` and
    ``assemble(model, duals) -> TrainState`` (a step-0 state with a new
    Adam over those modules)."""

    def __init__(self, step, init_state, assemble, use_fused_train: bool):
        self.step = step
        self.init_state = init_state
        self.assemble = assemble
        self.use_fused_train = use_fused_train


def make_train_step(exp: Experiment, device="cuda",
                    mesh: Optional[Mesh] = None) -> TrainStepBundle:
    """Build the train step of an experiment on ``device`` (the mesh's
    device when a ``mesh`` is given).

    ``lrs`` is the LR pyramid in descending scale (``lrs[0]`` is the model
    input); ``generator`` (a CPU ``torch.Generator``) draws the step's
    drop-path multipliers (DRCT; a DRN draws none). The metrics are 0-d
    tensors on the device: 'total' and one per loss term for DRCT,
    'total', 'primary' and 'dual' for DRN, and 'skipped' when the
    loss-spike skip is on.

    With a ``mesh``, ``lrs`` and ``hr`` are this rank's rows
    (``shard_batch``) and the gradients and metrics are averaged over the
    data ranks (trainer.py:289-330); a batch size that does not divide by
    ``n_data`` raises ``ValueError``. tp > 1 runs the eager model split
    over the tp ranks."""
    dev = resolve_device(device if mesh is None else mesh.device)
    check_training_precision(exp, dev)
    cfg = exp.model
    is_dual = isinstance(cfg, DRNModelConfig)
    nd = n_data(mesh)
    tp = 1 if mesh is None else mesh.tp
    # tp > 1 leaves the kernels for the eager model (trainer.py:188-196)
    fused = dev.type == "cuda" and not is_dual and tp == 1
    if exp.data.batch_size % nd:
        raise ValueError(
            f"batch_size {exp.data.batch_size} must divide by the mesh's "
            f"data-axis product {nd}")
    dtype = compute_dtype(exp.precision)
    # the loss of this rank's rows: its terms are local means, and the
    # mean of equal-sized local means is the global mean (trainer.py:302-304)
    loss_fn = make_loss(exp.optim.loss, batch_size=exp.data.batch_size // nd,
                        scale=max(exp.data.scale),
                        rgb_range=exp.data.rgb_range)
    skip_threshold = exp.optim.skip_threshold
    o = exp.optim

    def assemble(model: torch.nn.Module,
                 duals: Optional[torch.nn.ModuleList]) -> TrainState:
        params = list(model.parameters())
        if duals is not None:
            params += list(duals.parameters())
        # one Adam over primal and duals (trainer.py:338-345)
        opt = make_optimizer(params, o.beta1, o.beta2, o.epsilon,
                             o.weight_decay)
        return TrainState(step=0, model=model, optimizer=opt, duals=duals)

    def init_state(generator: torch.Generator) -> TrainState:
        primal, dual_sds = init_sr_params(cfg, generator, device=dev)
        model = make_model(cfg, device=dev)
        model.load_state_dict(primal)
        specs = param_shardings(model.state_dict(), mesh) if tp > 1 else {}
        if any(specs.values()):
            shard_model_(model, mesh, specs)
        duals = None
        if is_dual:
            duals = make_dual_models(cfg).to(dev)
            for d, sd in zip(duals, dual_sds):
                d.load_state_dict(sd)
        state = assemble(model, duals)
        state.specs = specs if any(specs.values()) else None
        return state

    def drct_loss(state: TrainState, lrs, hr, generator):
        lr0 = torch.as_tensor(lrs[0], device=dev)
        # the whole batch's multipliers, this rank's rows: the draws of
        # the single-card step
        dp = drop_path_mults(generator, cfg, hr.shape[0] * nd,
                             deterministic=False)
        if mesh is not None:
            dp = shard_rows(mesh, dp, dim=1)
        dp = dp.to(dev)
        if fused:
            sr = fused_drct_train_forward(
                dict(state.model.named_parameters()), cfg, lr0, dp, dtype)
        else:
            sr = state.model(lr0.float(), dp=dp)
        total, comps = loss_fn(sr, hr)
        return total, {"total": total, **comps}

    def drn_loss(state: TrainState, lrs, hr, generator):
        # the dual-regression composition, term for term
        # (adsr_tpu/train/trainer.py:231-251)
        lrs = [torch.as_tensor(lr, device=dev) for lr in lrs]
        sr = state.model(lrs[0], dtype=dtype)
        n, n_d = len(sr), len(state.duals)
        sr2lr = [apply_dual(state.duals[i], sr[i - n_d]) for i in range(n_d)]
        primary = loss_fn(sr[-1], hr)[0]
        for i in range(1, n):
            primary = primary + loss_fn(sr[i - 1 - n], lrs[i - n])[0]
        dual = sum(loss_fn(sr2lr[i], lrs[i])[0] for i in range(n_d))
        total = primary + o.dual_weight * dual
        return total, {"total": total, "primary": primary, "dual": dual}

    loss_of = drn_loss if is_dual else drct_loss

    def step(state: TrainState, lrs, hr, lr_rate: float,
             generator: torch.Generator, error_last: float = 1e8
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        opt = state.optimizer
        hr = torch.as_tensor(hr, device=dev)
        # f32 convs and products in full f32 (TF32 off), the backward's
        # too: the eager models', and the fused fp32 step's head and tail
        # convs, there with cuDNN's deterministic algorithms so that the
        # whole backward repeats bitwise as its kernels do (the bf16 fused
        # step's convs run in bf16)
        if not fused:
            context = full_f32()
        elif dtype == torch.float32:
            context = deterministic_f32()
        else:
            context = contextlib.nullcontext()
        with context:
            total, metrics = loss_of(state, lrs, hr, generator)
            opt.zero_grad(set_to_none=True)
            total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            params = [p for g in opt.param_groups for p in g["params"]]
            grads = mean_over_data(mesh, [
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in params])
            for p, g in zip(params, grads):
                p.grad = g
            metrics = dict(zip(metrics, mean_over_data(
                mesh, list(metrics.values()))))
        take = True
        if skip_threshold > 0:
            # loss-spike skip (reference trainer.py:190, 207-210; opt-in),
            # on the averaged total: every rank decides alike
            take = metrics["total"].item() < skip_threshold * error_last
            metrics["skipped"] = torch.tensor(0.0 if take else 1.0,
                                              device=dev)
        if take:
            for group in opt.param_groups:
                group["lr"] = lr_rate
            opt.step()
        state.step += 1
        return state, metrics

    return TrainStepBundle(step, init_state, assemble, fused)


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named stream of ``seed``."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Trainer:
    """Epoch loop with the reference's terminate/test cadence.

    On a ``mesh`` (the caller's: ``cli/main.py`` builds it from
    ``exp.mesh``; without one the Trainer is single-stream whatever
    ``exp.mesh`` says), every rank's sampler draws
    the same global batch and keeps its rows, the test's chunk is rounded
    to a multiple of ``n_data`` and its PSNR / SSIM lists are gathered, and
    only a rank given a ``journal`` logs and writes (rank 0, by the CLI).
    Every rank must call ``test``, ``save_train_state`` and
    ``load_train_state`` together: at tp > 1 they gather or split the
    state."""

    def __init__(self, exp: Experiment, train_ds: Optional[SRDataset],
                 test_ds: Optional[SRDataset],
                 journal: Optional[Journal] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        if journal is not None and not isinstance(journal, Journal):
            raise TypeError(f"Trainer: journal must be an io.journal.Journal, "
                            f"got {type(journal).__name__}")
        self.exp = exp
        self.journal = journal
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self._bundle = make_train_step(exp, self.device, mesh)
        self.train_step = self._bundle.step
        self.eval_forward = make_eval_forward(exp, self.device)
        self.state = self._bundle.init_state(
            torch.Generator().manual_seed(stream_seed(exp.seed, "init")))
        self.dropout_gen = torch.Generator().manual_seed(
            stream_seed(exp.seed, "dropout"))
        self.epoch = 0
        self.error_last = 1e8
        self.loss_history: List[Dict[str, float]] = []
        self.psnr_ssim_history: List[Tuple[float, float]] = []
        self.best: Dict[str, Tuple[float, int]] = {}
        self.sampler = None
        if train_ds is not None:
            self.sampler = EpochSampler(
                train_ds, exp.data.batch_size, exp.data.test_every,
                exp.data.patch_size, exp.data.no_augment, seed=exp.seed,
                device=self.device)
        self.test_ds = test_ds

    def _log(self, msg: str) -> None:
        if self.journal is not None:
            self.journal.write_log(msg)
        elif self.mesh is None or self.mesh.rank == 0:
            print(msg, flush=True)

    # ------------------- the state in the full layout ------------------- #

    def _param_names(self) -> List[str]:
        return [n for n, _ in self.state.model.named_parameters()]

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` in the full reference layout (at tp >
        1 gathered over the tp ranks: every rank calls it)."""
        sd = self.state.model.state_dict()
        if self.state.specs is None:
            return sd
        return gather_state_dict(sd, self.mesh, self.state.specs)

    def load_model_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a full-layout ``state_dict`` (this rank's shard at tp > 1)."""
        if self.state.specs is not None:
            sd = shard_state_dict(sd, self.mesh, self.state.specs)
        self.state.model.load_state_dict(sd)

    def checkpoint_state(self) -> TrainState:
        """The train state in the full layout: the state itself, or at tp >
        1 a whole model and Adam gathered from the tp ranks."""
        st = self.state
        if st.specs is None:
            return st
        model = make_model(self.exp.model, device=self.device)
        model.load_state_dict(self.model_state_dict())
        full = self._bundle.assemble(model, st.duals)
        full.optimizer.load_state_dict(gather_optimizer_state(
            st.optimizer.state_dict(), self._param_names(), st.specs,
            self.mesh))
        full.step = st.step
        return full

    def save_train_state(self) -> None:
        """Checkpoint everything a resume needs through the Journal."""
        full = self.checkpoint_state()
        if self.journal is not None:
            self.journal.save_train_state(full, self.epoch, self.dropout_gen,
                                          self.error_last)

    def load_train_state(self) -> None:
        """Resume from the run dir's ``train_state_latest.pt`` (the
        Journal's, or ``exp.save``'s on a rank without one): the model,
        Adam, step, epoch, drop-path generator and last epoch loss, so the
        next step is the one an uninterrupted run would take."""
        root = self.journal.dir if self.journal is not None \
            else Path(self.exp.save)
        full = self.checkpoint_state()
        extra = load_train_state(root / "model" / TRAIN_STATE, full,
                                 self.dropout_gen)
        if full is not self.state:      # this rank's shards of it
            self.load_model_state_dict(full.model.state_dict())
            self.state.optimizer.load_state_dict(shard_optimizer_state(
                full.optimizer.state_dict(), self._param_names(),
                self.state.specs, self.mesh))
            self.state.step = full.step
        self.epoch = extra["epoch"]
        if extra["error_last"] is not None:
            self.error_last = extra["error_last"]

    # ------------------------------------------------------------------ #

    def train_one_epoch(self) -> Dict[str, float]:
        if self.sampler is None:
            raise ValueError("Trainer.train_one_epoch: no training dataset")
        exp = self.exp
        lr_rate = cosine_lr(self.epoch, exp.optim.lr, exp.optim.eta_min,
                            exp.optim.epochs)
        self._log(f"[Epoch {self.epoch + 1}]\tLearning rate: {lr_rate:.2e}")
        # metrics accumulate on the device; the host reads them only at
        # print points and at the end of the epoch
        t_data, t_model = 0.0, 0.0
        t0 = time.time()
        acc: Dict[str, torch.Tensor] = {}
        n_batches = 0
        for lrs, hr in self.sampler.epoch(self.epoch):
            if self.mesh is not None:     # every rank drew the same batch
                lrs, hr = shard_batch(self.mesh, lrs), shard_batch(self.mesh,
                                                                   hr)
            t1 = time.time()
            t_data += t1 - t0
            self.state, metrics = self.train_step(
                self.state, lrs, hr, lr_rate, self.dropout_gen,
                self.error_last)
            for k, v in metrics.items():
                acc[k] = acc[k] + v if k in acc else v
            n_batches += 1
            t0 = time.time()
            t_model += t0 - t1
            if n_batches % exp.print_every == 0:
                shown = "".join(f"[{k}: {float(v) / n_batches:.4f}]"
                                for k, v in acc.items())
                t0 = time.time()
                self._log(f"[{n_batches * exp.data.batch_size}/"
                          f"{self.sampler.dataset_length}]\t{shown}"
                          f"\t{t_model:.1f}+{t_data:.1f}s")
                t_model, t_data = 0.0, 0.0
        mean = {k: float(v) / max(n_batches, 1) for k, v in acc.items()}
        self.loss_history.append(mean)
        self.error_last = mean.get("total", self.error_last)
        self.epoch += 1
        return mean

    def test(self, test_ds: Optional[SRDataset] = None,
             save_results_fn=None) -> Tuple[float, float]:
        """PSNR/SSIM over a test split, in batches of the training batch
        size (trainer.py:643-698); a DRN is scored on its full-scale SR.
        With a Journal, the model is saved as ``model_latest.pt`` and, when
        this PSNR is the best so far, as ``model_best.pt`` (a DRN's duals
        as ``dual_model_latest.pt`` / ``dual_model_best.pt``).
        ``save_results_fn(filename, sr)`` receives every SR image. On a
        mesh each chunk (a multiple of ``n_data``, the last one padded with
        its last image) is split over the data ranks and the scores and SR
        rows are gathered."""
        ds = test_ds if test_ds is not None else self.test_ds
        if ds is None:
            raise ValueError("Trainer.test: no test dataset")
        self._log("\nEvaluation:")
        exp = self.exp
        mesh = self.mesh
        lrs_dev, hr_dev = ds.device_arrays(self.device)
        t0 = time.time()
        params = self.model_state_dict()
        bsz = max(1, min(exp.data.batch_size, ds.n))
        nd = n_data(mesh)
        if mesh is not None:
            bsz = max(nd, bsz // nd * nd)
        psnrs, ssims = [], []
        for i in range(0, ds.n, bsz):
            lr, hr = lrs_dev[0][i:i + bsz], hr_dev[i:i + bsz]
            n_real = hr.shape[0]
            if mesh is not None:
                pad = bsz - n_real
                lr, hr = (torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
                          if pad else t for t in (lr, hr))
                lr, hr = shard_rows(mesh, lr), shard_rows(mesh, hr)
            sr = self.eval_forward(params, lr)
            sr = sr[:, :hr.shape[1], :hr.shape[2], :]
            p_b = psnr_shave4(sr, hr, exp.data.rgb_range)
            s_b = ssim_shave4(sr, hr, exp.data.rgb_range)
            if mesh is not None:
                p_b, s_b, sr = (gather_rows(mesh, t)[:n_real]
                                for t in (p_b, s_b, sr))
            psnrs.extend(p_b.tolist())
            ssims.extend(s_b.tolist())
            if save_results_fn is not None:
                for j in range(sr.shape[0]):
                    save_results_fn(ds.filenames[i + j], sr[j])
        p, s = float(np.mean(psnrs)), float(np.mean(ssims))
        self.psnr_ssim_history.append((p, s))
        for name, val in (("PSNR", p), ("SSIM", s)):
            if val > self.best.get(name, (-np.inf, 0))[0]:
                self.best[name] = (val, len(self.psnr_ssim_history))
        if self.journal is not None:
            self.journal.save_model(
                params, is_best=self.best["PSNR"][1] == len(
                    self.psnr_ssim_history),
                duals=self.state.dual_state_dicts())
        bp, bpe = self.best["PSNR"]
        bs, bse = self.best["SSIM"]
        self._log(f"[{exp.data.data_test} x{max(exp.data.scale)}]\t"
                  f"PSNR: {p:.2f} (Best: {bp:.2f} @epoch {bpe})\t"
                  f"SSIM: {s:.4f} (Best: {bs:.4f} @epoch {bse})")
        self._log(f"Total time: {time.time() - t0:.2f}s\n")
        return p, s

    def terminate(self) -> bool:
        if self.exp.test_only:
            self.test()
            return True
        return self.epoch >= self.exp.optim.epochs
