"""Guards of the port: it imports neither JAX nor the JAX package, and the
card-only smoke script refuses to run without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax_and_no_repro():
    names = [m for _, m in _port_modules()]
    assert "repro_torch.launch.collab_serve" in names and len(names) >= 20
    assert {"repro_torch.launch.train", "repro_torch.configs.seamless_m4t_large_v2",
            "repro_torch.configs.llama_3_2_vision_90b"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_source_imports_jax_or_repro_anywhere():
    """Also catches imports inside functions, which a run may not reach."""
    for path in [p for p, _ in _port_modules()] + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert not top.startswith("jax") and top != "repro", f"{path}: {m}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script's own run is the check there")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
