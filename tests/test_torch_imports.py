"""The port stands alone: no module of ``rgbd_gan_tpu_torch`` imports JAX,
flax, optax or the JAX package, and none imports yaml or PIL at module
level (the GPU machine may lack them). ``chip_smoke.py`` and the card
tests obey the same rules. Checked on the sources with ``ast``, without
importing them.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rgbd_gan_tpu"}
LAZY_ONLY = {"yaml", "PIL"}
# what runs on the GPU machine: the port, the smoke script, the card tests
SOURCES = sorted((ROOT / "rgbd_gan_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "test_torch_kernels_cuda.py",
]


def _imports(tree):
    """(top-level module name, at module level?) for every import in ``tree``."""
    top_level = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top_level


def test_sources_found():
    assert len(SOURCES) > 20
    found = {str(p.relative_to(ROOT)) for p in SOURCES}
    # the DeepVoxels path's modules and K6's are among what is checked
    assert {
        "rgbd_gan_tpu_torch/ops/_build.py", "rgbd_gan_tpu_torch/ops/trilinear.py",
        "rgbd_gan_tpu_torch/models/deepvoxels.py", "rgbd_gan_tpu_torch/models/extras.py",
        "rgbd_gan_tpu_torch/train/steps_deepvoxels.py", "rgbd_gan_tpu_torch/ops/conv.py",
        "rgbd_gan_tpu_torch/tools/bench_conv.py",
    } <= found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_module_level_yaml_or_pil(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, module_level in _imports(tree):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        if module_level:
            assert name not in LAZY_ONLY, f"{path.name} imports {name} at module level"


def test_checker_catches_violations():
    bad = ast.parse("import jax\ndef f():\n    import yaml\nimport PIL.Image\n")
    found = list(_imports(bad))
    assert ("jax", True) in found and ("yaml", False) in found and ("PIL", True) in found
