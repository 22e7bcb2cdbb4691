"""The port's synthetic MVTec source tree against the JAX package's on the
CPU: with the JAX class offset (``hash(classe) % 1000``, computed in this
process) patched in, both generators write the same decoded pixels for every
class; unpatched, the port's tree is the same in every process, whatever
``PYTHONHASHSEED`` salts ``str`` hashes with."""

import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from adsr_tpu.data import synthetic as jsyn

from adsr_tpu_torch.data import synthetic as psyn

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_train=3, n_test_good=2, n_test_bad_per_defect=2, size=64,
             seed=5)


def _tree(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*.png")):
        with Image.open(p) as im:
            out[str(p.relative_to(root))] = np.asarray(im)
    return out


@pytest.mark.parametrize("classe", ["grid", "carpet", "grid-hard",
                                    "carpet-hard"])
def test_generator_equals_jax_with_its_class_offset(classe, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(psyn, "class_offset", lambda c: hash(c) % 1000)
    psyn.generate_synthetic_mvtec(str(tmp_path / "port"), classes=(classe,),
                                  **SMALL)
    jsyn.generate_synthetic_mvtec(str(tmp_path / "jax"), classes=(classe,),
                                  **SMALL)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    defects = {"grid": ("blob", "scratch"), "carpet": ("blob", "tear")} \
        .get(classe, ("faint",))
    assert sorted(got) == sorted(want) and len(got) == 3 + 2 + 2 * len(defects)
    assert {Path(k).parent.name for k in got} == {"good", *defects}
    for k in want:
        assert got[k].shape == (64, 64, 3) and np.array_equal(got[k], want[k])


def test_class_offset_is_a_crc_of_the_name():
    for classe in ("grid", "carpet", "grid-hard", "carpet-hard", "bottle"):
        assert psyn.class_offset(classe) == \
            zlib.crc32(classe.encode()) % 1000


def test_tree_is_the_same_in_every_process(tmp_path):
    code = ("import sys\n"
            "from adsr_tpu_torch.data.synthetic import "
            "generate_synthetic_mvtec\n"
            "generate_synthetic_mvtec(sys.argv[1], classes=('grid', "
            "'carpet-hard'), n_train=2, n_test_good=1, "
            "n_test_bad_per_defect=1, size=32)\n")
    for salt in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-c", code, str(tmp_path / salt)], cwd=REPO,
            env=dict(os.environ, PYTHONHASHSEED=salt, PYTHONPATH=str(REPO)),
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
    a = sorted((tmp_path / "1").rglob("*.png"))
    b = sorted((tmp_path / "2").rglob("*.png"))
    assert len(a) == 5 + 4                    # grid, carpet-hard
    assert [p.relative_to(tmp_path / "1") for p in a] == \
        [p.relative_to(tmp_path / "2") for p in b]
    for p, q in zip(a, b):
        assert p.read_bytes() == q.read_bytes(), p
