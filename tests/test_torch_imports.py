"""The port stands alone: no JAX, flax, msgpack or cellseg_tpu imports.

Walks the AST of every module of cellseg_tpu_torch and of chip_smoke.py.
PIL may be imported only inside functions; no env kill-switch exists;
every module imports here, without a card, nvcc or triton.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cellseg_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "cellseg_tpu",
             "triton"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[:-len(".__init__")]
        mods.append(rel)
    return mods


def _imports(tree):
    """(top-level module name, inside a function?) for every import."""
    out = []

    def visit(node, in_fn):
        if isinstance(node, ast.Import):
            out.extend((a.name.split(".")[0], in_fn) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module.split(".")[0], in_fn))
        fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        for child in ast.iter_child_nodes(node):
            visit(child, in_fn or fn)

    visit(tree, False)
    return out


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_imports(path):
    with open(path) as f:
        source = f.read()
    for name, in_fn in _imports(ast.parse(source)):
        assert name not in FORBIDDEN, f"{path} imports {name}"
        if name == "PIL":
            assert in_fn, f"{path} imports PIL at module level"
    assert "CELLSEG_NO_" not in source


@pytest.mark.parametrize("module", _modules())
def test_module_imports_without_a_card(module):
    importlib.import_module(module)


def test_every_kernel_source_is_bound():
    """Each csrc/*.cu is loaded by a wrapper module of ops/kernels."""
    from cellseg_tpu_torch.kernels import build

    wrappers = ""
    kdir = os.path.join(PKG, "ops", "kernels")
    for f in os.listdir(kdir):
        if f.endswith(".py"):
            with open(os.path.join(kdir, f)) as fh:
                wrappers += fh.read()
    assert build.sources() == ["local_cc", "scans", "sweeps", "ws_local",
                               "ws_sweeps"]
    for name in build.sources():
        assert f'build.load("{name}"' in wrappers
