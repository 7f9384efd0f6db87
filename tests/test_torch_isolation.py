"""The port stands alone: no module of ``rdfind_tpu_torch`` (nor ``chip_smoke.py``)
imports JAX or the JAX package, and an entry point given no device raises when
there is no CUDA device instead of running on the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rdfind_tpu_torch
from rdfind_tpu_torch.ops import kernels
from torch_harness import port_module, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "rdfind_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "rdfind_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    names = [rdfind_tpu_torch.__name__]
    for info in pkgutil.walk_packages(rdfind_tpu_torch.__path__,
                                      prefix="rdfind_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    """Every import statement, including those inside functions."""
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "rdfind_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import importlib
for name in {modules!r}:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
assert not any(m.split(".")[0] in ("jax", "jaxlib", "rdfind_tpu")
               for m in sys.modules)
print("ok")
"""


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    code = _BLOCKER.format(repo=REPO, modules=_modules())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=100, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_point_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    triples = np.array([[0, 1, 2], [3, 1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        rdfind_tpu_torch.discover(triples, 1, strategy=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rdfind_tpu_torch.discover(triples, 1, strategy=0, device="cuda")


def test_sharded_entry_points_raise_without_a_device_when_cuda_is_absent(
        monkeypatch, tmp_path):
    """discover_sharded, discover_on, the launcher and the CLI's --dop run on
    CUDA ranks unless the caller asks for the CPU."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.parallel import launch
    from rdfind_tpu_torch.programs import rdfind as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    triples = np.array([[0, 1, 2], [3, 1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.discover_sharded(triples, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.discover_on(triples, 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.spawn(sharded.discover_sharded, 2)
    f = tmp_path / "d.nt"
    f.write_text("<a> <p> <b> .\n<c> <p> <b> .\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([str(f), "--support", "1", "--traversal-strategy", "0",
                   "--dop", "2"])


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from rdfind_tpu_torch.programs import rdfind as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "d.nt"
    f.write_text("<a> <p> <b> .\n<c> <p> <b> .\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([str(f), "--support", "1", "--traversal-strategy", "0"])


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_kernel_wrapper_refuses_other_devices():
    m = torch.zeros((256, 128), dtype=torch.int8, device="meta")
    col = torch.zeros(128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.fused_cind_blocks(
            m, m, col, col, col, col, col, col, col, col, col,
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.ones(1, dtype=torch.int32, device="meta"),
            ref_lo=0, ref_chunk=128,
            block_counts=torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            dep_lo=0, split=1)
    words = torch.zeros((64, 64), dtype=torch.int32, device="meta")
    popc = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.packed_contains_matrix(words, words, popc)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.repeat_probe(popc.reshape(1, 64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.pipeline_probe(torch.zeros((16, 128), device="meta"))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_native_library_builds_into_build_not_the_jax_package():
    """The port builds native/rdfind_native.cpp itself into build/ and never
    loads or builds the JAX package's library."""
    from rdfind_tpu_torch.io import native

    assert native.library_path().parent == native.BUILD_DIR
    assert str(native.BUILD_DIR) == os.path.join(REPO, "build")
    assert str(native.SOURCE) == os.path.join(REPO, "native",
                                              "rdfind_native.cpp")
    for path in _sources():
        text = open(path).read()
        assert "_rdfind_native.so" not in text, path
        assert "RDFIND_NATIVE_SO" not in text, path
