"""The PyTorch port stands alone: neither the package nor ``chip_smoke.py``
imports JAX or anything of the JAX package, and both run without them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "web_rwkv_gguf_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "web_rwkv_gguf_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_forbidden_prefix_check():
    """The port's own name starts with the JAX package's name; only the
    JAX package and its submodules are flagged."""
    assert _forbidden("web_rwkv_gguf_tpu")
    assert _forbidden("web_rwkv_gguf_tpu.models.forward")
    assert _forbidden("jax.numpy")
    assert not _forbidden("web_rwkv_gguf_tpu_torch")
    assert not _forbidden("web_rwkv_gguf_tpu_torch.models")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every port module imports in a process where importing JAX or the
    JAX package fails."""
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import web_rwkv_gguf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert all(sys.modules.get(n) is None for n in {FORBIDDEN!r})
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


# the modules that serve across ranks: each is among the files checked above
RANK_MODULES = ("parallel/__init__.py", "parallel/sharding.py", "parallel/tensor.py",
                "parallel/decode_pp.py", "parallel/launch.py", "parallel/pipeline.py",
                "parallel/sequence.py", "runtime/distributed.py")


@pytest.mark.parametrize("rel", RANK_MODULES)
def test_rank_modules_are_checked(rel):
    path = PORT / rel
    assert path in _port_files()
    assert not [m for m in _imports(path) if _forbidden(m)]


# the compiled step's modules: the CUDA graphs of the Engine's forward and
# of the decode segment, each among the files checked above
GRAPH_MODULES = ("runtime/graph.py", "runtime/engine.py", "models/generate.py")


@pytest.mark.parametrize("rel", GRAPH_MODULES)
def test_graph_modules_are_checked(rel):
    path = PORT / rel
    assert path in _port_files()
    assert not [m for m in _imports(path) if _forbidden(m)]


def rank_modules(rank, world):
    """A spawned rank's imported modules of JAX or the JAX package, after
    importing the port's parallel and runtime packages."""
    import web_rwkv_gguf_tpu_torch.parallel  # noqa: F401
    import web_rwkv_gguf_tpu_torch.runtime  # noqa: F401

    return sorted(m for m in sys.modules if _forbidden(m))


def test_spawned_ranks_import_no_jax():
    """Ranks started by ``parallel/launch.py`` (spawned: a fresh interpreter
    each) hold no module of JAX or the JAX package, although this process
    may."""
    from web_rwkv_gguf_tpu_torch.parallel.launch import launch

    assert launch(f"{__name__}:rank_modules", 2, deadline=60, timeout=30) == [[], []]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no CUDA card (as here), chip_smoke.py exits non-zero at once
    and prints no result line."""
    if _cuda_available():
        pytest.skip("a CUDA card is present")
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()
