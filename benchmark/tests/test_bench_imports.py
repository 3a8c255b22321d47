"""What the benchmark may import, by whole top-level module names (the
part before the first dot): ``aniportrait_tpu_torch`` begins with
``aniportrait_tpu``, so a prefix test would be wrong."""

import ast
from pathlib import Path

import pytest

from harness.cli import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "aniportrait_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"aniportrait_tpu_torch", "harness"})


def test_whole_name_comparison():
    assert forbidden_modules(["aniportrait_tpu_torch", "aniportrait_tpu_torch.ops",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["aniportrait_tpu.models.unet", "jax._src", "numpy"]) == [
        "aniportrait_tpu", "jax"]


def test_the_program_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import manifest as mf\n"
            "for k in ('pose2vid', 'train'): mf.driver(k)\n"
            "import aniportrait_tpu_torch.pipelines.pose2vid, aniportrait_tpu_torch.train.stage2\n"
            "from harness.cli import forbidden_modules\n"
            "print(forbidden_modules())" % (str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
