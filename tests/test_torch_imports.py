"""(f) The port imports no JAX: a fresh interpreter imports every module of
aniportrait_tpu_torch (including the numpy-only modules of aniportrait_tpu
it reuses: pipelines.context and weights.convert) and jax stays out of
sys.modules.  The GPU smoke's path (factory, pipeline, kernels, a
whole-clip generation) loads nothing of aniportrait_tpu at all."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import aniportrait_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    names = sorted(
        m.name for m in pkgutil.walk_packages(aniportrait_tpu_torch.__path__,
                                              "aniportrait_tpu_torch.")
    )
    assert "aniportrait_tpu_torch.pipelines.pose2vid" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_smoke_path_loads_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from aniportrait_tpu_torch import factory\n"
        "pipe = factory.build_pipeline('micro')\n"
        "rs = np.random.RandomState(0)\n"
        "img = rs.randint(0, 255, (64, 64, 3), np.uint8)\n"
        "pipe(img, [img, img], None, 64, 64, 2, num_inference_steps=1)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('aniportrait_tpu.', 'jax')))\n"
        "assert 'aniportrait_tpu' not in sys.modules and not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
