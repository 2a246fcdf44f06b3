"""pathtracker_torch stands alone: it imports neither JAX nor flax nor
msgpack nor pathtracker_tpu, and its entry points never fall back to the
CPU on their own."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import pathtracker_torch
from pathtracker_torch.eval import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pathtracker_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "optax", "pathtracker_tpu"}


def _port_files():
    scripts = os.path.join(ROOT, "scripts")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(scripts, n) for n in os.listdir(scripts)
              if n.startswith("torch_") and n.endswith(".py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _modules():
    mods = []
    for path in _port_files():
        if path.startswith(PKG):
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def test_no_forbidden_import_statements():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            offenders += [f"{path}:{node.lineno} {r}" for r in roots if r in FORBIDDEN]
    assert not offenders, offenders


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None  # any import of it raises ImportError
        for mod in {_modules()!r}:
            importlib.import_module(mod)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in {sorted(FORBIDDEN)!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok", len({_modules()!r}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build()
    with pytest.raises(RuntimeError, match="CUDA"):
        pathtracker_torch.resolve_device()
    assert pathtracker_torch.resolve_device("cpu") == torch.device("cpu")


def test_numerics_flags_are_pinned():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
