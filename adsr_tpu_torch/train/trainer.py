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
head, tail, loss and Adam in PyTorch), bf16 only. On the CPU it runs the
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
distributions, not the same bits. Single device: no mesh (ROADMAP Queue 1
item 11). With a ``Journal`` (``io/journal.py``) the Trainer logs into the
run dir, saves ``model_latest.pt`` / ``model_best.pt`` (and DRN's
``dual_model_*.pt``) at every test and checkpoints its full state for a
true resume; without one it logs with ``print``.

The serving forwards (``make_serving_forward``, ``make_eval_forward``,
``make_tiled_serving_forward``) take the full-scale SR ``sr[-1]`` of a DRN
and, for DRCT, ``mode``: ``"rdg"`` runs each RDG on kernels (a)-(c),
``"block"`` each Swin block on kernel (g); ``None`` reads ``ADSR_TPU_RDG``
as the JAX package does. On the card ``make_serving_forward`` and
``make_tiled_serving_forward`` serve through one CUDA graph per LR shape
(``core/graphs.py``), as the JAX versions jit theirs; ``graphs=False``
launches every kernel from Python on every call. ``make_eval_forward``
takes new params on every call, so it launches.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.config import (DRCTModelConfig, DRNModelConfig,
                                        Experiment)
from adsr_tpu_torch.core.device import (compute_dtype, full_f32,
                                        resolve_device)
from adsr_tpu_torch.core.graphs import CapturedCall
from adsr_tpu_torch.data.pipeline import EpochSampler, SRDataset
from adsr_tpu_torch.eval.tiled import feather_weights, tiled_sr_forward
from adsr_tpu_torch.io.journal import Journal
from adsr_tpu_torch.kernels.fused_drct import fused_drct_apply, prepack_drct
from adsr_tpu_torch.kernels.fused_rdg_train import fused_drct_train_forward
from adsr_tpu_torch.metrics import psnr_shave4, quantize, ssim_shave4
from adsr_tpu_torch.models.drct import drop_path_mults
from adsr_tpu_torch.models.drn import apply_dual, make_dual_models
from adsr_tpu_torch.models.factory import init_sr_params, make_model
from adsr_tpu_torch.train.losses import make_loss


def check_serving_precision(exp: Experiment, device: torch.device) -> None:
    """The CUDA kernels are bf16; DRCT's fp32 runs only on the CPU plain
    path. DRN-L runs no kernel of the port and takes both precisions."""
    if isinstance(exp.model, DRNModelConfig):
        return
    if not isinstance(exp.model, DRCTModelConfig):
        raise NotImplementedError(
            f"the port has no model for {type(exp.model).__name__}")
    if device.type == "cuda" and exp.precision != "bf16":
        raise NotImplementedError(
            f"precision {exp.precision!r} on CUDA: the kernels are bf16 only; "
            "fp32 kernels are ROADMAP.md Queue 1 item 8, 'fp32 serving "
            "kernels' (on the CPU, fp32 runs the plain path)")


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
                         mode: Optional[str] = None, graphs: bool = True
                         ) -> CapturedCall:
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
    or a tensor on any device."""
    dev = resolve_device(device)
    check_serving_precision(exp, dev)
    sr_of = _sr_function(exp, params, dev, mode)

    @torch.no_grad()
    def forward(lr: torch.Tensor) -> torch.Tensor:
        sr = sr_of(lr)
        return quantize(sr, exp.data.rgb_range) if quantize_out else sr

    return CapturedCall(forward, dev, capture=graphs)


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
    check_serving_precision(exp, dev)
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
                               graphs: bool = True) -> CapturedCall:
    """Serving forward for LR inputs larger than the model's tile
    (trainer.py:460-515): the LR batch is cut into overlapping ``tile``-sized
    crops, all of them go through one forward (DRCT's packed at the tile
    size) and the SR tiles are feather-blended (``eval/tiled.py``). ``tile``
    defaults to DRCT's ``img_size`` and to 32 for a DRN (trainer.py:479-480).
    Returns ``forward(lr)``: on the card the whole call (crops, forward,
    blend, quantisation) runs as one CUDA graph per LR shape, as the JAX
    version jits it; ``graphs=False`` launches it."""
    dev = resolve_device(device)
    check_serving_precision(exp, dev)
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

    return CapturedCall(forward, dev, capture=graphs)


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

    def dual_state_dicts(self) -> Optional[List[Dict[str, torch.Tensor]]]:
        """The dual models' ``state_dict``s (the reference's
        ``dual_model_*.pt`` layout), or None without duals."""
        if self.duals is None:
            return None
        return [d.state_dict() for d in self.duals]


class TrainStepBundle:
    """``step(state, lrs, hr, lr_rate, generator, error_last) -> (state,
    metrics)`` and ``init_state(generator) -> TrainState``."""

    def __init__(self, step, init_state, use_fused_train: bool):
        self.step = step
        self.init_state = init_state
        self.use_fused_train = use_fused_train


def make_train_step(exp: Experiment, device="cuda") -> TrainStepBundle:
    """Build the train step of an experiment on ``device``.

    ``lrs`` is the LR pyramid in descending scale (``lrs[0]`` is the model
    input); ``generator`` (a CPU ``torch.Generator``) draws the step's
    drop-path multipliers (DRCT; a DRN draws none). The metrics are 0-d
    tensors on the device: 'total' and one per loss term for DRCT,
    'total', 'primary' and 'dual' for DRN, and 'skipped' when the
    loss-spike skip is on."""
    dev = resolve_device(device)
    check_serving_precision(exp, dev)
    cfg = exp.model
    is_dual = isinstance(cfg, DRNModelConfig)
    fused = dev.type == "cuda" and not is_dual
    dtype = compute_dtype(exp.precision)
    loss_fn = make_loss(exp.optim.loss, batch_size=exp.data.batch_size,
                        scale=max(exp.data.scale),
                        rgb_range=exp.data.rgb_range)
    skip_threshold = exp.optim.skip_threshold
    o = exp.optim

    def init_state(generator: torch.Generator) -> TrainState:
        primal, dual_sds = init_sr_params(cfg, generator, device=dev)
        model = make_model(cfg, device=dev)
        model.load_state_dict(primal)
        params = list(model.parameters())
        duals = None
        if is_dual:
            duals = make_dual_models(cfg).to(dev)
            for d, sd in zip(duals, dual_sds):
                d.load_state_dict(sd)
            params += list(duals.parameters())
        # one Adam over primal and duals (trainer.py:338-345)
        opt = make_optimizer(params, o.beta1, o.beta2, o.epsilon,
                             o.weight_decay)
        return TrainState(step=0, model=model, optimizer=opt, duals=duals)

    def drct_loss(state: TrainState, lrs, hr, generator):
        lr0 = torch.as_tensor(lrs[0], device=dev)
        dp = drop_path_mults(generator, cfg, hr.shape[0],
                             deterministic=False).to(dev)
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
        # DRN's f32 convs and products in full f32, the backward's too
        with full_f32() if is_dual else contextlib.nullcontext():
            total, metrics = loss_of(state, lrs, hr, generator)
            opt.zero_grad(set_to_none=True)
            total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        take = True
        if skip_threshold > 0:
            # loss-spike skip (reference trainer.py:190, 207-210; opt-in)
            take = total.item() < skip_threshold * error_last
            metrics["skipped"] = torch.tensor(0.0 if take else 1.0,
                                              device=dev)
        if take:
            for group in opt.param_groups:
                group["lr"] = lr_rate
            opt.step()
        state.step += 1
        return state, metrics

    return TrainStepBundle(step, init_state, fused)


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named stream of ``seed``."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Trainer:
    """Epoch driver with the reference's terminate/test cadence."""

    def __init__(self, exp: Experiment, train_ds: Optional[SRDataset],
                 test_ds: Optional[SRDataset],
                 journal: Optional[Journal] = None, device="cuda"):
        if journal is not None and not isinstance(journal, Journal):
            raise TypeError(f"Trainer: journal must be an io.journal.Journal, "
                            f"got {type(journal).__name__}")
        self.exp = exp
        self.journal = journal
        self.device = resolve_device(device)
        self._bundle = make_train_step(exp, self.device)
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
        else:
            print(msg, flush=True)

    def save_train_state(self) -> None:
        """Checkpoint everything a resume needs through the Journal."""
        self.journal.save_train_state(self.state, self.epoch,
                                      self.dropout_gen, self.error_last)

    def load_train_state(self) -> None:
        """Resume from the Journal's ``train_state_latest.pt``: the model,
        Adam, step, epoch, drop-path generator and last epoch loss, so the
        next step is the one an uninterrupted run would take."""
        extra = self.journal.load_train_state(self.state, self.dropout_gen)
        self.epoch = extra["epoch"]
        if extra["error_last"] is not None:
            self.error_last = extra["error_last"]

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
        ``save_results_fn(filename, sr)`` receives every SR image."""
        ds = test_ds if test_ds is not None else self.test_ds
        if ds is None:
            raise ValueError("Trainer.test: no test dataset")
        self._log("\nEvaluation:")
        exp = self.exp
        lrs_dev, hr_dev = ds.device_arrays(self.device)
        t0 = time.time()
        params = self.state.model.state_dict()
        bsz = max(1, min(exp.data.batch_size, ds.n))
        psnrs, ssims = [], []
        for i in range(0, ds.n, bsz):
            hr = hr_dev[i:i + bsz]
            sr = self.eval_forward(params, lrs_dev[0][i:i + bsz])
            sr = sr[:, :hr.shape[1], :hr.shape[2], :]
            psnrs.extend(psnr_shave4(sr, hr, exp.data.rgb_range).tolist())
            ssims.extend(ssim_shave4(sr, hr, exp.data.rgb_range).tolist())
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
