"""The port stands alone: no module of adsr_tpu_torch, and not chip_smoke.py,
imports jax, flax or the JAX package, nor PIL or matplotlib (the card's
machine has no PIL), and the package imports with them blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "adsr_tpu"}
NOT_ON_THE_CARD = {"PIL", "matplotlib"}
FILES = sorted((REPO / "adsr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_pil_or_matplotlib_imports(path):
    bad = set(_imported_roots(path)) & NOT_ON_THE_CARD
    assert not bad, f"{path} imports {bad}"


def test_entry_point_and_io_modules_are_covered():
    names = {str(p.relative_to(REPO)) for p in FILES}
    assert {"adsr_tpu_torch/cli/main.py", "adsr_tpu_torch/cli/evaluate.py",
            "adsr_tpu_torch/cli/prepare.py", "adsr_tpu_torch/cli/smoke.py",
            "adsr_tpu_torch/data/prepare.py",
            "adsr_tpu_torch/data/synthetic.py",
            "adsr_tpu_torch/io/png.py", "adsr_tpu_torch/io/journal.py",
            "adsr_tpu_torch/eval/tiled.py", "adsr_tpu_torch/eval/rundir.py",
            "adsr_tpu_torch/models/drn.py",
            "adsr_tpu_torch/kernels/fused_swin_block.py",
            "adsr_tpu_torch/cli/efficientad.py",
            "adsr_tpu_torch/models/efficientad.py",
            "adsr_tpu_torch/train/efficientad.py",
            "adsr_tpu_torch/train/distill.py"} <= names


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'flax', 'adsr_tpu', 'PIL', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import adsr_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(adsr_tpu_torch.__path__,"
        " 'adsr_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
