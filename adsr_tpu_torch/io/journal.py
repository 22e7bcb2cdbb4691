"""Run dirs: logging, config dump, checkpoints, result images (the port of
``adsr_tpu/io/journal.py``, same layout):

    <save>/
      log.txt                      append-only run log (also printed)
      config.txt                   timestamp + flat ``key: value`` config dump
      metrics.jsonl                one JSON record per epoch
      loss_log.json, psnr_ssim_log.json
      model/
        model_latest.pt            the model's state_dict (model_best.pt too)
        dual_model_latest.pt       DRN: the dual models' state_dicts, a list
                                   (dual_model_best.pt too)
        train_state_latest.pt      model, duals, Adam state, step, epoch and
                                   the dropout generator's state: a true
                                   resume
      results/<data_test>/x<s>/    SR PNG dumps
      loss_<key>.pdf               a curve per loss term (total; DRN:
                                   primary and dual too)
      test_<data_test>_psnr_ssim.pdf   the validation PSNR and SSIM

The ``.pt`` files hold the port's ``state_dict``, whose names are the
reference torch module names: a reference ``model_*.pt`` loads as it is, and
``adsr_tpu/io/torch_convert.py`` (``convert_drct`` + ``stack_scan_layers``)
maps the port's into the JAX model (``convert_drn`` + ``stack_drn_rcabs``
for DRN-L). The plots are vector PDFs drawn by ``io/pdf.py`` in the JAX
package's matplotlib layout (the card's machine has no matplotlib).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from adsr_tpu_torch.core.config import Experiment
from adsr_tpu_torch.io.pdf import Page, line_panel, write_pdf
from adsr_tpu_torch.io.png import write_png


def _host(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_state_dict(path: Path, state_dict: Mapping[str, torch.Tensor]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_host(state_dict), path)


TRAIN_STATE = "train_state_latest.pt"


def load_state_dict(path, device="cpu"):
    """A ``.pt`` state_dict (the port's or a reference checkpoint's), or a
    ``dual_model_*.pt`` list of them."""
    return torch.load(path, map_location=device, weights_only=True)


class Journal:
    """Run-dir manager (the reference's Checkpoint equivalent)."""

    def __init__(self, exp: Experiment, save_dir: Optional[str] = None):
        self.exp = exp
        self.dir = Path(save_dir or exp.save)
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "model").mkdir(exist_ok=True)
        (self.dir / "results").mkdir(exist_ok=True)
        mode = "a" if (self.dir / "log.txt").exists() else "w"
        self._log_file = open(self.dir / "log.txt", mode)
        now = datetime.datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
        with open(self.dir / "config.txt", mode) as f:
            f.write(now + "\n\n")
            for k, v in exp.to_flat_dict().items():
                f.write(f"{k}: {v}\n")
            f.write("\n")

    # ------------------------------ logging ---------------------------- #

    def write_log(self, msg: str, refresh: bool = False) -> None:
        print(msg, flush=True)
        self._log_file.write(msg + "\n")
        if refresh:
            self._log_file.flush()

    def log_metrics(self, record: Dict[str, Any]) -> None:
        """Append one JSON line to metrics.jsonl."""
        with open(self.dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")

    def done(self) -> None:
        if not self._log_file.closed:
            self._log_file.close()

    # ---------------------------- checkpoints --------------------------- #

    def save_model(self, state_dict: Mapping[str, torch.Tensor],
                   is_best: bool = False,
                   duals: Optional[Sequence[Mapping[str, torch.Tensor]]] = None
                   ) -> None:
        """``model_latest.pt`` (and ``model_best.pt``); with ``duals``
        (DRN), ``dual_model_latest.pt`` (and ``dual_model_best.pt``): the
        list of the dual models' state_dicts, the reference's layout
        (src/model.py:123-147)."""
        names = ("latest", "best") if is_best else ("latest",)
        for name in names:
            save_state_dict(self.dir / "model" / f"model_{name}.pt",
                            state_dict)
            if duals is not None:
                torch.save([_host(sd) for sd in duals],
                           self.dir / "model" / f"dual_model_{name}.pt")

    def save_train_state(self, state, epoch: int,
                         generator: Optional[torch.Generator] = None,
                         error_last: Optional[float] = None) -> None:
        """Full state for a true resume: the model, DRN's duals, the Adam
        state (one over primal and duals), the step, the epoch reached, the
        drop-path generator and the last epoch loss (the loss-spike skip's
        reference)."""
        path = self.dir / "model" / TRAIN_STATE
        duals = state.dual_state_dicts()
        torch.save({"model": _host(state.model.state_dict()),
                    "duals": None if duals is None
                    else [_host(sd) for sd in duals],
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "epoch": epoch,
                    "generator": None if generator is None
                    else generator.get_state(),
                    "error_last": error_last}, path)

    def load_train_state(self, state,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, Any]:
        """:func:`load_train_state` from this run dir."""
        return load_train_state(self.dir / "model" / TRAIN_STATE, state,
                                generator)

    def save(self, trainer, is_best: bool = False, state=None) -> None:
        """End-of-training bundle (src/checkpoint.py:30-48 equivalent).
        ``state`` (default ``trainer.state``) is the train state in the
        full layout (``Trainer.checkpoint_state()`` at tp > 1)."""
        state = state if state is not None else trainer.state
        self.save_model(state.model.state_dict(), is_best=is_best,
                        duals=state.dual_state_dicts())
        self.save_train_state(state, trainer.epoch,
                              trainer.dropout_gen, trainer.error_last)
        with open(self.dir / "loss_log.json", "w") as f:
            json.dump(trainer.loss_history, f)
        with open(self.dir / "psnr_ssim_log.json", "w") as f:
            json.dump(trainer.psnr_ssim_history, f)
        self.plot_loss(trainer.loss_history)
        self.plot_psnr_ssim(trainer.psnr_ssim_history)

    # ----------------------------- artifacts ---------------------------- #

    def save_result_image(self, filename: str, sr, scale: int,
                          data_test: str = "") -> None:
        """SR PNG export (src/checkpoint.py:107-125 layout)."""
        out_dir = self.dir / "results" / data_test / f"x{scale}"
        out_dir.mkdir(parents=True, exist_ok=True)
        arr = sr.detach().cpu().numpy() if torch.is_tensor(sr) \
            else np.asarray(sr)
        u8 = np.clip(arr * (255.0 / self.exp.data.rgb_range), 0, 255
                     ).astype(np.uint8)
        write_png(out_dir / f"{filename}.png", u8)

    def plot_loss(self, history: List[Dict[str, float]]) -> None:
        """``loss_{key}.pdf`` for each loss term of the epoch history: its
        mean per epoch (the JAX layout, journal.py:176-189)."""
        if not history:
            return
        axis = list(range(1, len(history) + 1))
        for k in sorted(history[0]):
            page = Page(460.8, 345.6)       # matplotlib's default 6.4 x 4.8 in
            line_panel(page, (58.0, 46.0, 445.0, 318.0), axis,
                       [h[k] for h in history], f"{k} Loss", "Epochs", "Loss",
                       f"{k} Loss")
            write_pdf(self.dir / f"loss_{k}.pdf", [page])

    def plot_psnr_ssim(self, history: List[Tuple[float, float]]) -> None:
        """``test_{data_test}_psnr_ssim.pdf``: PSNR and SSIM per validation
        test, side by side (journal.py:191-212)."""
        if not history:
            self.write_log("No evaluation logs available; skipping PSNR/SSIM plot")
            return
        axis = list(range(1, len(history) + 1))
        data = self.exp.data
        page = Page(720.0, 360.0)           # 10 x 5 in
        for i, name in enumerate(("PSNR", "SSIM")):
            left = 360.0 * i
            line_panel(page, (left + 62.0, 46.0, left + 350.0, 330.0), axis,
                       [h[i] for h in history],
                       f"SR on {data.data_test} - {name}", "Epochs", name,
                       f"Scale {max(data.scale)}")
        write_pdf(self.dir / f"test_{data.data_test}_psnr_ssim.pdf", [page])


def load_train_state(path, state, generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Any]:
    """Restore ``state`` (model, duals, optimizer, step) and ``generator``
    in place from a ``train_state_latest.pt``; returns ``{"epoch",
    "error_last"}``. Raises ``FileNotFoundError`` without one."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no train state at {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    if state.duals is not None:
        for dual, sd in zip(state.duals, ckpt["duals"]):
            dual.load_state_dict(sd)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if generator is not None and ckpt["generator"] is not None:
        generator.set_state(ckpt["generator"])
    return {"epoch": int(ckpt["epoch"]), "error_last": ckpt["error_last"]}
