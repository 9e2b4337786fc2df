"""Model comparison (counterpart of ``porous_cfd_tpu/pipelines/compare.py``):
evaluates two checkpoints on the same split, then runs Kruskal-Wallis and
Mann-Whitney U over their absolute errors, Shapiro, Levene and one-way
ANOVA over the errors' logs, and writes ``Test.csv`` and ``Shapiro.csv``
under ``<checkpoint grandparent>/comparisons/<name 1> vs <name 2>/<split>/``.

The numbers need numpy and scipy only, so the comparison runs on the card's
machine. Under ``--save-plots`` it also draws the per-case delta plots and
the two ``Errors.csv`` tables side by side (matplotlib).
"""
from __future__ import annotations

import dataclasses
import json
from argparse import ArgumentParser, Namespace
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.pipelines import evaluation
from porous_cfd_tpu_torch.pipelines.evaluation import Evaluation, evaluate_split
from porous_cfd_tpu_torch.pipelines.inference import restore
from porous_cfd_tpu_torch.viz.common import get_fields_names, plot_multi_bar, plot_per_case

TESTS = ("Kruskal-Wallis", "Mann-Whitney U", "ANOVA")


def build_arg_parser() -> ArgumentParser:
    """Evaluation CLI + --checkpoint-other (compare.py:15-22)."""
    p = evaluation.build_arg_parser()
    p.add_argument("--checkpoint-other", type=str)
    return p


def switch_active_checkpoint(args: Namespace) -> Namespace:
    d = vars(args)
    d["checkpoint"], d["checkpoint_other"] = (d["checkpoint_other"],
                                              d["checkpoint"])
    return Namespace(**d)


def get_name_from_checkpoint(checkpoint: str) -> str:
    """Model name from the checkpoint's parent directory (compare.py:53-60)."""
    name = Path(checkpoint).parent.name.replace("-", " ")
    return name if name[0].isupper() else name.capitalize()


def plot_error_comparison(name_1, name_2, errors_1: dict, errors_2: dict, plots_path):
    """The rows of two ``Errors.csv`` tables (label -> values) that both
    have, side by side, in the first table's order."""
    for m in [k for k in errors_1 if k in errors_2]:
        v1, v2 = np.asarray(errors_1[m]), np.asarray(errors_2[m])
        plot_multi_bar(m, {name_1: v1.tolist(), name_2: v2.tolist()},
                       get_fields_names(v1), plots_path)


def plot_max_difference(title, errors_1, errors_2, reduction_f, plots_path):
    delta = reduction_f(errors_1, axis=-2) - reduction_f(errors_2, axis=-2)
    plot_per_case(title, delta, plots_path)


def format_table(columns: list[str], rows: dict[str, list]) -> str:
    """A table as text, a row a label (what the JAX version prints as a
    DataFrame)."""
    width = max([len(str(k)) for k in rows] + [0])
    lines = [" " * width + "".join(f"  {c:>16}" for c in columns)]
    lines += [f"{k:<{width}}" + "".join(f"  {v:>16.6e}" for v in vals)
              for k, vals in rows.items()]
    return "\n".join(lines)


@dataclasses.dataclass
class Comparison:
    names: tuple[str, str]
    path: Path                      # the comparison's directory
    fields: list[str]               # Ux, Uy[, Uz], p
    test: dict                      # field -> p-values in TESTS order (Test.csv)
    shapiro: dict                   # field -> the two models' p-values (Shapiro.csv)
    levene: list                    # a p-value a field
    errors: tuple                   # the two (points, fields) absolute error arrays
    evaluations: tuple              # the two models' Evaluation

    def summary(self) -> dict:
        """The comparison's numbers as one JSON object."""
        return {"names": list(self.names), "dir": str(self.path),
                "cases": len(self.evaluations[0].results["U error"]),
                "test": {f: dict(zip(TESTS, v)) for f, v in self.test.items()},
                "shapiro": {f: dict(zip(self.names, v)) for f, v in self.shapiro.items()},
                "levene": dict(zip(self.fields, self.levene)),
                "inference_ms_per_case": [e.avg_inference_time * 1e3 for e in self.evaluations]}


def compare(args: Namespace, model1: PinnModel, model2: PinnModel,
            data: FoamDataset) -> Comparison:
    """Full comparison (compare.py:79-152): both models evaluated on
    ``data`` (each model's plots and ``Errors.csv`` under its own
    checkpoint's directory with ``--save-plots``), the statistical tests
    printed and written. The directory is
    ``<grandparent of --checkpoint-other>/comparisons/<name 1> vs <name 2>/
    <split>`` as the JAX version makes it (its arguments are switched to the
    second model by then); both checkpoints share ``lightning_logs``."""
    from scipy.stats import f_oneway, kruskal, levene, mannwhitneyu, shapiro

    results: dict = {}
    eval_paths: list = []
    evaluations: list[Evaluation] = []
    active = []

    def postprocess_fn(dataset, partial_results, plots_path):
        results[active[-1]] = partial_results
        eval_paths.append(plots_path)

    name_1 = get_name_from_checkpoint(args.checkpoint)
    name_2 = get_name_from_checkpoint(args.checkpoint_other)

    active.append(name_1)
    evaluations.append(evaluate_split(args, model1, data, None, postprocess_fn))
    active.append(name_2)
    args = switch_active_checkpoint(args)
    evaluations.append(evaluate_split(args, model2, data, None, postprocess_fn))

    plots_dir = (Path(args.checkpoint).parent.parent / "comparisons"
                 / f"{name_1} vs {name_2}" / Path(data.data_dir).name)
    plots_dir.mkdir(exist_ok=True, parents=True)

    errors_1 = np.concatenate([results[name_1]["U error"],
                               results[name_1]["p error"]], axis=-1)
    errors_2 = np.concatenate([results[name_2]["U error"],
                               results[name_2]["p error"]], axis=-1)

    if eval_paths[0] is not None:
        plot_max_difference("Max error difference", errors_1, errors_2, np.max,
                            plots_dir)
        plot_max_difference("Average error difference", errors_1, errors_2,
                            np.mean, plots_dir)

    errors_1 = np.concatenate(errors_1)
    errors_2 = np.concatenate(errors_2)

    index = ["Ux", "Uy", "Uz"][:errors_2.shape[-1] - 1] + ["p"]
    kw = kruskal(errors_1, errors_2, axis=0, keepdims=True)[-1].flatten()
    mw = mannwhitneyu(errors_1, errors_2, axis=0, keepdims=True)[-1].flatten()

    t1, t2 = np.log(errors_1), np.log(errors_2)
    sh = [shapiro(t, axis=0, keepdims=True)[-1].flatten() for t in (t1, t2)]
    shapiro_rows = {f: [float(sh[0][i]), float(sh[1][i])] for i, f in enumerate(index)}

    levene_p = [float(levene(t1[:, i], t2[:, i], center="mean")[-1])
                for i in range(t1.shape[-1])]
    print("Homoscedasticity transformed p-values")
    print(format_table(index, {0: levene_p}), "\n")

    anova = f_oneway(t1, t2, axis=0)[-1].flatten()
    test_rows = {f: [float(kw[i]), float(mw[i]), float(anova[i])] for i, f in enumerate(index)}

    print("Log transformed errors normality test p-values")
    print(format_table([name_1, name_2], shapiro_rows), "\n")
    print("Statistical tests p-values")
    print(format_table(list(TESTS), test_rows))

    if eval_paths[0] is not None:
        _, eval1 = evaluation.read_table(f"{eval_paths[0]}/Errors.csv")
        _, eval2 = evaluation.read_table(f"{eval_paths[1]}/Errors.csv")
        plot_error_comparison(name_1, name_2, eval1, eval2, plots_dir)
    evaluation.write_table(plots_dir / "Shapiro.csv", [name_1, name_2], shapiro_rows)
    evaluation.write_table(plots_dir / "Test.csv", list(TESTS), test_rows)
    return Comparison((name_1, name_2), plots_dir, index, test_rows, shapiro_rows, levene_p,
                      (errors_1, errors_2), tuple(evaluations))


def report(comparison: Comparison) -> Comparison:
    """Print the comparison's summary as one JSON line; returns it."""
    print(json.dumps(comparison.summary()), flush=True)
    return comparison


def run(argv, get_model, seed: int, device=None, dataset_cls=FoamDataset) -> Comparison:
    """An experiment's compare CLI: parse ``argv`` (the command line when
    None), load the split as a ``dataset_cls`` with the rng of ``seed``,
    restore both checkpoints (``--checkpoint`` and ``--checkpoint-other``)
    through ``get_model`` on ``device``, compare them and print the summary
    line; returns the comparison."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = dataset_cls(args.data_dir, args.n_internal, args.n_boundary, args.n_observations,
                       np.random.default_rng(seed), args.meta_dir)
    model1, _ = restore(args, data, get_model, device)
    other = Namespace(**{**vars(args), "checkpoint": args.checkpoint_other})
    model2, _ = restore(other, data, get_model, device)
    return report(compare(args, model1, model2, data))
