"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as bench_run

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "porous_cfd_tpu_torch_fake", object())
    assert "porous_cfd_tpu" not in bench_run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "porous_cfd_tpu.fake", object())
    assert bench_run.loaded_forbidden() == ["porous_cfd_tpu"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    return names


def _source(module: str):
    base = ROOT / module.replace(".", "/")
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.exists():
            return path
    return None


@pytest.mark.parametrize("start", ["reference", "families", "datasets"])
def test_reference_imports_nothing_of_the_program(start):
    """The reference, each family's work count and forward and each
    dataset, and everything of the benchmark they import."""
    seen, todo = set(), sorted(PORTBENCH.joinpath(start).glob("*.py"))
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = mod if isinstance(mod, Path) else _source(mod)
        if path is None:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("porous_cfd_tpu_torch", *bench_run.FORBIDDEN), (mod, name)
            if top == "portbench":
                todo.append(name)


@pytest.mark.parametrize("path", sorted(PORTBENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in bench_run.FORBIDDEN, (path, name)


def test_a_whole_run_loads_no_jax(tiny_root):
    """A tiny cell run end to end in a fresh process: nothing in
    ``sys.modules`` is JAX's or the JAX package's once it has run."""
    code = ("import sys, torch\n"
            "from pathlib import Path\n"
            "from portbench import run\n"
            f"rc = run.main(['--workload', 'pipn_duct2d.tiny_serve', '--seed', '5', "
            f"'--seconds', '0.1'], device=torch.device('cpu'), root=Path({str(tiny_root)!r}))\n"
            "assert rc == 0, rc\n"
            "print('LOADED', run.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
