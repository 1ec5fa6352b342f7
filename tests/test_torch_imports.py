"""The port stands alone: importing it pulls in neither JAX nor any module
of the JAX package, and chip_smoke.py refuses to run without a card."""

import ast
import os
import subprocess
import sys

import redgnn_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import redgnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(redgnn_tpu_torch.__path__,
                                               "redgnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or m == "redgnn_tpu" or m.startswith("redgnn_tpu."))
print(len(names), bad)
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15, out.stdout  # every submodule was imported
    assert bad == "[]", bad


def test_port_sources_name_no_jax():
    """No import statement of the port or chip_smoke.py names JAX, flax or
    the JAX package (also catches imports inside functions)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    pkg_dir = os.path.dirname(redgnn_tpu_torch.__file__)
    for dirpath, _, names in os.walk(pkg_dir):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "redgnn_tpu"), \
                    (path, m)


def test_chip_smoke_fails_without_card(tmp_path):
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line; alone in a directory (without the port) it fails too."""
    import torch

    runs = [ROOT]
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    runs.append(str(alone))
    for cwd in runs:
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=_clean_env(), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0, (cwd, out.stdout)
        assert '"ok": true' not in out.stdout
