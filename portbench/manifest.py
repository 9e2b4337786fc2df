"""``BENCHMARK.json`` and the files it names, each found by its name: a
configuration (``configs/``), a traffic mix (``traffic/``), a cell's limits
(``limits/``), a per-layer metric's reader (``metrics/``), and the code a
name in those files picks: a model family's work count and plain reference
(``families/<family>.py``), a configuration's inputs
(``datasets/<dataset>.py``) and a mix's kind of run (``kinds/<kind>.py``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


def _dir(root: Path, kind: str) -> Path:
    return root / "portbench" / kind


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{', '.join(w['name'] for w in manifest['workloads'])}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((_dir(root, "traffic") / f"{name}.json").read_text())


def limits(cell_name: str, root: Path = ROOT) -> dict:
    """The cell's limits {number: {"limit": x, ...}} (``limits/<cell>.json``)."""
    return json.loads((_dir(root, "limits") / f"{cell_name}.json").read_text())


def metrics(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (an entry without ``workloads`` applies to
    every cell that reports the end-to-end metric it moves)."""
    def applies(m, e2e_names=None):
        if "workloads" in m:
            return cell_name in m["workloads"]
        return e2e_names is None or m["moves"] in e2e_names

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"] if applies(m, names)]


def plugin(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``portbench/<kind>/<name>.py`` of the checkout ``root``,
    loaded from its path (once a path)."""
    path = _dir(root, kind) / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.name!r} under {path.parent}")
    key = f"portbench_{kind}_{abs(hash(str(path.resolve())))}_{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def reader(metric_name: str, root: Path = ROOT):
    """The ``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return plugin("metrics", metric_name, root).read


@dataclasses.dataclass(frozen=True)
class Spec:
    """A configuration with the code its names pick: its family's module
    (``families/<family>.py``) and its inputs' (``datasets/<dataset>.py``)."""
    cfg: dict
    family: ModuleType
    dataset: ModuleType


def spec(manifest: dict, name: str, root: Path = ROOT) -> Spec:
    cfg = config(manifest, name, root)
    return Spec(cfg, plugin("families", cfg["family"], root),
                plugin("datasets", cfg["dataset"], root))
