"""(f) The port imports nothing of JAX or of the JAX package: a fresh
interpreter imports every module of aniportrait_tpu_torch, and neither jax,
flax nor aniportrait_tpu (or any module under them) is in sys.modules.  The
GPU smoke's path (factory, pipeline, kernels, a whole-clip generation) loads
none of them either."""

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'aniportrait_tpu'))\n"
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
        "pipe = factory.build_pipeline('micro', device='cpu')\n"
        "rs = np.random.RandomState(0)\n"
        "img = rs.randint(0, 255, (64, 64, 3), np.uint8)\n"
        "pipe(img, [img, img], None, 64, 64, 2, num_inference_steps=1)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'aniportrait_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
