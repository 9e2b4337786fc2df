"""The port's mesh-asset and render-smoke tools: the eleven primitives
byte for byte as checked in, and the render smoke's SKIP / FAILED contract
with PyVista and bpy blocked or stubbed."""
import sys
import types
from pathlib import Path

import pytest

from porous_cfd_tpu_torch.tools import make_mesh_assets, render_smoke

ROOT = Path(__file__).resolve().parents[1]
STANDARD = ROOT / "examples/duct_fixed_boundary/assets/meshes/standard"


def test_make_mesh_assets_writes_the_checked_in_bytes(tmp_path):
    paths = make_mesh_assets.main([str(tmp_path / "meshes")])
    checked_in = sorted(STANDARD.glob("*.obj"))
    assert len(paths) == len(checked_in) == 11
    assert sorted(p.name for p in paths) == [p.name for p in checked_in]
    for path in paths:
        assert path.read_bytes() == (STANDARD / path.name).read_bytes(), path.name


def test_make_mesh_assets_needs_a_destination():
    with pytest.raises(SystemExit):
        make_mesh_assets.main([])


def test_render_smoke_skips_what_is_not_installed(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pyvista", None)
    monkeypatch.setitem(sys.modules, "bpy", None)
    assert render_smoke.main(["--out", str(tmp_path / "out")]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["pyvista: SKIP (pyvista not installed)", "bpy: SKIP (bpy not installed)"]


def test_render_smoke_fails_when_an_installed_package_fails(tmp_path, monkeypatch, capsys):
    broken = types.ModuleType("pyvista")

    def fail(*args, **kwargs):
        raise RuntimeError("no display")

    broken.ImageData = fail
    monkeypatch.setitem(sys.modules, "pyvista", broken)
    monkeypatch.setitem(sys.modules, "bpy", None)
    assert render_smoke.main(["--out", str(tmp_path / "out")]) == 1
    out = capsys.readouterr().out
    assert "pyvista: FAILED" in out and "bpy: SKIP" in out
