"""Run dirs: logging, config dump, checkpoints, result images (the port of
``adsr_tpu/io/journal.py``, same layout):

    <save>/
      log.txt                      append-only run log (also printed)
      config.txt                   timestamp + flat ``key: value`` config dump
      metrics.jsonl                one JSON record per epoch
      loss_log.json, psnr_ssim_log.json
      model/
        model_latest.pt            the model's state_dict (model_best.pt too)
        train_state_latest.pt      model, Adam state, step, epoch and the
                                   dropout generator's state: a true resume
      results/<data_test>/x<s>/    SR PNG dumps

The ``.pt`` files hold the port's ``state_dict``, whose names are the
reference torch module names: a reference ``model_*.pt`` loads as it is, and
``adsr_tpu/io/torch_convert.py`` (``convert_drct`` + ``stack_scan_layers``)
maps the port's into the JAX model. The loss and PSNR/SSIM plots (matplotlib
PDFs in the JAX package) wait for a later slice.
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from adsr_tpu_torch.core.config import Experiment
from adsr_tpu_torch.io.png import write_png


def save_state_dict(path: Path, state_dict: Mapping[str, torch.Tensor]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_state_dict(path, device="cpu") -> Dict[str, torch.Tensor]:
    """A ``.pt`` state_dict (the port's or a reference checkpoint's)."""
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
                   is_best: bool = False) -> None:
        save_state_dict(self.dir / "model" / "model_latest.pt", state_dict)
        if is_best:
            save_state_dict(self.dir / "model" / "model_best.pt", state_dict)

    def save_train_state(self, state, epoch: int,
                         generator: Optional[torch.Generator] = None,
                         error_last: Optional[float] = None) -> None:
        """Full state for a true resume: the model, the Adam state, the step,
        the epoch reached, the drop-path generator and the last epoch loss
        (the loss-spike skip's reference)."""
        path = self.dir / "model" / "train_state_latest.pt"
        torch.save({"model": {k: v.detach().cpu() for k, v in
                              state.model.state_dict().items()},
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "epoch": epoch,
                    "generator": None if generator is None
                    else generator.get_state(),
                    "error_last": error_last}, path)

    def load_train_state(self, state,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, Any]:
        """Restore ``state`` (model, optimizer, step) and ``generator`` in
        place from ``train_state_latest.pt``; returns ``{"epoch",
        "error_last"}``. Raises ``FileNotFoundError`` without one."""
        path = self.dir / "model" / "train_state_latest.pt"
        if not path.is_file():
            raise FileNotFoundError(f"no train state at {path}")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        if generator is not None and ckpt["generator"] is not None:
            generator.set_state(ckpt["generator"])
        return {"epoch": int(ckpt["epoch"]), "error_last": ckpt["error_last"]}

    def save(self, trainer, is_best: bool = False) -> None:
        """End-of-training bundle (src/checkpoint.py:30-48 equivalent)."""
        self.save_model(trainer.state.model.state_dict(), is_best=is_best)
        self.save_train_state(trainer.state, trainer.epoch,
                              trainer.dropout_gen, trainer.error_last)
        with open(self.dir / "loss_log.json", "w") as f:
            json.dump(trainer.loss_history, f)
        with open(self.dir / "psnr_ssim_log.json", "w") as f:
            json.dump(trainer.psnr_ssim_history, f)
        self.write_log("Loss and PSNR/SSIM plots: not written (eval/visual.py "
                       "is a later slice of the port); the numbers are in "
                       "loss_log.json and psnr_ssim_log.json")

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
