"""The port stands alone: no JAX, flax or optax, and nothing of the JAX
package, anywhere in ``dlrover_tpu_torch/`` or ``chip_smoke.py``.

An AST scan of every import statement (including those inside
functions), so a lazy import cannot slip past.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dlrover_tpu_torch")
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "dlrover_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port package
                continue
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_has_the_expected_files():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for need in (
        "chip_smoke.py",
        "dlrover_tpu_torch/ops/flash_attention.py",
        "dlrover_tpu_torch/models/transformer.py",
        "dlrover_tpu_torch/serving/engine.py",
        "dlrover_tpu_torch/embedding/device_cache.py",
        "dlrover_tpu_torch/embedding/kernels.py",
        "dlrover_tpu_torch/examples/train_rec.py",
        "dlrover_tpu_torch/examples/train_lm.py",
        "dlrover_tpu_torch/data/loader.py",
        "dlrover_tpu_torch/trainer/elastic_trainer.py",
        "dlrover_tpu_torch/runtime/mesh.py",
        "dlrover_tpu_torch/parallel/quantized_collectives.py",
        "dlrover_tpu_torch/optimizers/zero1.py",
    ):
        assert need in rel


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_or_reference_package_imports(path):
    bad = [
        f"{os.path.relpath(path, REPO)}:{line} imports {mod}"
        for line, mod in _imported_modules(path)
        if mod.split(".")[0] in FORBIDDEN_ROOTS
    ]
    assert not bad, "\n".join(bad)
