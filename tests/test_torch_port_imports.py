"""The port stands alone: no file of ``rvos_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX, flax or the JAX package, and importing
every module of the port leaves ``jax`` out of ``sys.modules`` — and
cv2 and PIL, which an installation for the GPU need not have (the port
reads and writes images with PIL inside the functions that need it)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rvos_tpu"}


def _port_files():
    files = sorted((ROOT / "rvos_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists()
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


# modules whose JAX counterparts import jax, optax, orbax, cv2 or PIL at
# the top (the pipeline, loader, datasets, perturbations, metrics, the
# training engine, its losses, optimizer, checkpoints, logging and CLI,
# the MobileNet backbone):
# the port keeps its own copies, and the checks here must cover them
_STANDALONE = ("data/datasets.py", "data/loader.py", "data/perturb.py",
               "data/transforms.py", "engine/eval.py",
               "engine/eval_pipeline.py", "engine/loss.py",
               "engine/learning.py", "engine/train.py",
               "engine/checkpoint.py", "engine/grad_check.py", "ops/prng.py",
               "ops/train_matching.py", "cli/train.py",
               "cli/profile_train.py", "utils/davis_metrics.py",
               "utils/eval_zip.py", "utils/meters.py", "utils/logging.py",
               "utils/image.py", "models/mobilenet.py",
               "parallel/__init__.py", "parallel/mesh.py",
               "parallel/distributed.py", "parallel/context.py",
               "parallel/launch.py", "engine/dp_check.py")


@pytest.mark.parametrize("rel", _STANDALONE)
def test_pipeline_and_data_modules_are_checked(rel):
    assert ROOT / "rvos_tpu_torch" / rel in _port_files()


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rvos_tpu_torch\n"
        "for m in pkgutil.walk_packages(rvos_tpu_torch.__path__, "
        "'rvos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'rvos_tpu', 'cv2', 'PIL'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
