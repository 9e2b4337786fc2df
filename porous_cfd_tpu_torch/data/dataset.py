"""FoamDataset: OpenFOAM-case point-cloud dataset with stratified sampling
(the port's counterpart of ``porous_cfd_tpu/data/dataset.py``).

Numpy-native counterpart of ``dataset/foam_dataset.py:93-440`` in the
reference, producing static-shape ``FoamData`` cases over numpy arrays on
the host; the trainer moves the stacked cases to the model's device once.
The semantics are mirrored:

  * ``data_config.json`` drives fields, variable boundaries, dims and
    normalization; scalers come from ``meta.json`` statistics; sampling is
    constrained by ``min_points.json`` (parent directory).
  * stratified sampling proportional to per-subdomain mean counts with
    min-count rebalancing (``get_stratified_sampling_n``, :188-234);
  * internal sampling stratified over fluid/porous via ``cellToRegion``;
  * observation indices drawn from internal points only;
  * variable-BC feature columns ``<field>-<patch>`` zero-filled elsewhere;
  * SDF feature (min distance to boundary points, max-normalized, porous side
    negative) and one-hot boundaryId features;
  * column order: fields (component-expanded), sdf, boundaryId one-hots,
    variable-BC columns (the reference's pandas concat union order).

Since every case samples to the same fixed (n_internal, n_boundary, n_obs)
counts, all cases share shapes and can be stacked into one array. The same
split, rng and arguments give the JAX package's data, labels, domain and
normalizers; its subdomain indices are int32, the port's FoamData keeps
int64.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from porous_cfd_tpu_torch.data import parser
from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.data.scalers import scalers_from_meta
from porous_cfd_tpu_torch.ops.distance import sdf_feature

Table = dict[str, np.ndarray]  # field -> (N, w) float array, insertion-ordered


class FoamDataset:
    """Loads a split of OpenFOAM cases into memory as FoamData point clouds."""

    def __init__(self, data_dir: str,
                 n_internal: int,
                 n_boundary: int,
                 n_obs: int,
                 rng: np.random.Generator,
                 meta_dir: str | None = None,
                 extra_fields: list[str] = [],
                 regions_weights: dict[str, float] | None = None):
        self.data_dir = data_dir
        self.n_internal = n_internal
        self.n_boundary = n_boundary
        self.n_obs = n_obs
        self.rng = rng
        self.regions_weights = regions_weights

        with open(Path(data_dir) / "data_config.json") as f:
            cfg = json.load(f)
        self.fields = list(cfg["Fields"]) + list(extra_fields)
        self.variable_boundaries = cfg["Variable boundaries"]
        self.dim_labels = cfg["Dims"]
        self.normalize_fields = cfg["Normalize fields"]
        self.n_dims = len(self.dim_labels)

        self.samples = sorted(d for d in Path(data_dir).iterdir() if d.is_dir())

        self.meta = parser.parse_meta(meta_dir or data_dir)
        self.normalizers = {}
        if self.normalize_fields is not None:
            self.normalizers = scalers_from_meta(self.meta, self.normalize_fields)

        with open(Path(data_dir).parent / "min_points.json") as f:
            self.min_points = json.load(f)
        self.min_boundary = sum(v for k, v in self.min_points.items()
                                if k not in ("internal", "fluid", "porous"))

        self.check_sample_size()

        # Pristine full-resolution parses are only retained once resample()
        # is first called (training-with-resampling is the sole consumer);
        # val/test/eval datasets would otherwise pin every case's full parse
        # in host RAM for their lifetime (ADVICE r3).
        self._cache_parses = False
        self._parse_cache: dict[str, tuple[Table, dict[str, Table]]] = {}
        self.data = [self.load_case(str(c)) for c in self.samples]

    # -- constraints -----------------------------------------------------
    def check_sample_size(self):
        if self.n_internal > self.min_points["internal"]:
            raise ValueError(
                f"Cannot sample {self.n_internal} points from "
                f"{self.min_points['internal']} points!")
        if self.n_boundary > self.min_boundary:
            raise ValueError(
                f"Cannot sample {self.n_boundary} points from "
                f"{self.min_boundary} points!")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, item) -> FoamData:
        return self.data[item]

    # -- stratified sampling ----------------------------------------------
    def get_weights(self, names: list[str]) -> np.ndarray:
        w = np.ones(len(names))
        if self.regions_weights:
            for i, b in enumerate(names):
                if b in self.regions_weights:
                    w[i] = self.regions_weights[b]
        return w

    def get_stratified_sampling_n(self, subdomain_names: list[str],
                                  total_sample_size: int) -> np.ndarray:
        """Reference algorithm (foam_dataset.py:188-234): proportional targets
        from per-subdomain mean counts, then iterative redistribution of the
        excess over subdomains that still have headroom."""
        n_min = np.array([self.min_points[b] for b in subdomain_names], np.int64)
        n_mean = np.array([self.meta["Points"][b]["Mean"]
                           for b in subdomain_names]).astype(np.int64)
        fractions = n_mean / np.sum(n_mean) * self.get_weights(subdomain_names)
        fractions = fractions / np.sum(fractions)
        target_n = (fractions * total_sample_size).astype(np.int64)

        exceeding = np.maximum(target_n - n_min, 0)
        n_free = int(np.count_nonzero(exceeding <= 0))
        total_to_redist = int(np.sum(exceeding) + total_sample_size - np.sum(target_n))

        for idx in np.argsort(n_min):
            if exceeding[idx] > 0:
                continue
            added = min(n_min[idx], total_to_redist // n_free)
            target_n[idx] += added
            n_free -= 1
            total_to_redist -= added
        target_n[exceeding > 0] = n_min[exceeding > 0]

        exceeding = np.maximum(target_n - n_min, 0)
        if np.sum(exceeding) != 0:
            bad = [(subdomain_names[i], int(exceeding[i]))
                   for i in np.nonzero(exceeding > 0)[0]]
            raise RuntimeError(
                "Unable to satisfy sampling constraints. The following samples "
                f"exceed the minimum:\n{bad}")
        return target_n

    def sample_boundary(self, patches: dict[str, Table]) -> dict[str, Table]:
        names = list(patches.keys())
        target = self.get_stratified_sampling_n(names, self.n_boundary)
        out = {}
        for i, name in enumerate(names):
            table = patches[name]
            n = len(next(iter(table.values())))
            rows = self.rng.choice(n, replace=False, size=target[i])
            out[name] = {f: v[rows] for f, v in table.items()}
        return out

    def sample_internal(self, internal: Table) -> Table:
        target = self.get_stratified_sampling_n(["fluid", "porous"],
                                                self.n_internal)
        zone = internal["cellToRegion"][:, 0]
        fluid_rows = np.nonzero(zone == 0)[0]
        porous_rows = np.nonzero(zone > 0)[0]
        picked = np.concatenate([
            fluid_rows[self.rng.choice(len(fluid_rows), replace=False,
                                       size=target[0])],
            porous_rows[self.rng.choice(len(porous_rows), replace=False,
                                        size=target[1])]])
        return {f: v[picked] for f, v in internal.items()}

    def sample_obs(self, n_internal_rows: int) -> np.ndarray:
        """Observation indices into the internal rows (foam_dataset.py:277-284)."""
        return self.rng.choice(n_internal_rows, replace=False, size=self.n_obs)

    # -- feature construction ----------------------------------------------
    def normalize(self, table: Table):
        # float64 data against the float32 statistics, in float64 (numpy's
        # promotion, as the JAX package computes it)
        for f, norm in self.normalizers.items():
            if f in table:
                table[f] = norm.transform(torch.from_numpy(table[f])).numpy()

    def get_variable_boundaries(self, patches: dict[str, Table]) -> Table:
        """Variable-BC columns ``<field>-<patch>``, zero outside their patch
        (foam_dataset.py:315-333). Supports single components like 'Ux'."""
        out: Table = {}
        sizes = {p: len(next(iter(t.values()))) for p, t in patches.items()}
        total = sum(sizes.values())
        offsets = dict(zip(sizes, np.cumsum([0] + list(sizes.values())[:-1])))
        for var_field, var_patch in self.variable_boundaries.items():
            table = patches[var_patch]
            if var_field in table:
                src = table[var_field]
            else:  # single component, e.g. 'Ux'
                base, dim = var_field[:-1], var_field[-1]
                src = table[base][:, [self.dim_labels.index(dim)]]
            col = np.zeros((total, src.shape[1]))
            o = offsets[var_patch]
            col[o:o + len(src)] = src
            out[f"{var_field}-{var_patch}"] = col
        return out

    def add_sdf(self, internal: Table, patches: dict[str, Table]):
        """SDF feature (foam_dataset.py:360-381): min distance from every point
        to the boundary points, max-normalized; internal porous side negative.
        Large clouds go through the chunked reduction (``sdf_feature``)
        instead of one O(N*M) matrix."""
        bnd_points = np.concatenate([t["C"] for t in patches.values()])
        all_points = np.concatenate([internal["C"], bnd_points])
        if "C" in self.normalizers:
            c = self.normalizers["C"]
            all_points = c.inverse_transform(torch.from_numpy(all_points)).numpy()
            bnd_points = c.inverse_transform(torch.from_numpy(bnd_points)).numpy()
        n_int = len(internal["C"])
        if all_points.shape[0] * bnd_points.shape[0] > 2_000_000:
            sdf = sdf_feature(all_points[:n_int], bnd_points,
                              internal["cellToRegion"][:, 0])
            internal["sdf"] = sdf[:n_int][:, None]
            off = n_int
            for t in patches.values():
                n = len(t["C"])
                t["sdf"] = sdf[off:off + n][:, None]
                off += n
            return
        d = np.linalg.norm(all_points[:, None, :] - bnd_points[None, :, :],
                           axis=-1)
        sdf = np.min(d, axis=-1)
        sdf = sdf / np.max(sdf)
        sign = (0.5 - internal["cellToRegion"][:, 0]) * 2
        internal["sdf"] = (sdf[:n_int] * sign)[:, None]
        off = n_int
        for t in patches.values():
            n = len(t["C"])
            t["sdf"] = sdf[off:off + n][:, None]
            off += n

    def add_boundary_id(self, internal: Table, patches: dict[str, Table]):
        """One-hot boundaryId over the (sorted) patch names; internal rows are
        all-zero (foam_dataset.py:383-395)."""
        names = list(patches.keys())
        internal["boundaryId"] = np.zeros((len(internal["C"]), len(names)))
        for i, (name, t) in enumerate(patches.items()):
            oh = np.zeros((len(t["C"]), len(names)))
            oh[:, i] = 1.0
            t["boundaryId"] = oh
        self._boundary_names = names

    def add_features(self, internal: Table, patches: dict[str, Table]):
        """Override to customize features (foam_dataset.py:397-404)."""
        self.add_sdf(internal, patches)
        self.add_boundary_id(internal, patches)

    # -- assembly ------------------------------------------------------------
    def _sublabels(self, field: str, width: int) -> list[str] | None:
        if field == "boundaryId":
            return [f"boundaryId{n}" for n in self._boundary_names]
        if width == 1:
            return None
        return [f"{field}{self.dim_labels[i]}" for i in range(width)]

    def build_labels(self, columns: dict[str, int]) -> dict:
        """FoamData labels from {field: width}: single labels first (in column
        order), composites after (foam_dataset.py:296-313)."""
        labels: dict = {}
        composites: dict = {}
        for field, width in columns.items():
            sub = self._sublabels(field, width)
            if sub is None:
                labels[field] = None
            else:
                for s in sub:
                    labels[s] = None
                composites[field] = sub
        labels.update(composites)
        return labels

    def _parsed_case(self, case_dir: str) -> tuple[Table, dict[str, Table]]:
        """Parse a case, returning fresh copies (``load_case`` mutates its
        tables via normalize/sampling). Pristine parses are cached only when
        ``_cache_parses`` is on (flipped by :meth:`resample`), so resampling
        rounds cost only the sampling/feature stage, not IO — while datasets
        that never resample keep parse-and-discard memory behavior."""
        cached = self._parse_cache.get(case_dir)
        if cached is None:
            internal = parser.parse_internal_fields(case_dir, *self.fields,
                                                    max_dim=self.n_dims)
            patches = parser.parse_boundary_fields(case_dir, *self.fields,
                                                   max_dim=self.n_dims)
            if self._cache_parses:
                self._parse_cache[case_dir] = (internal, patches)
            else:
                return internal, patches  # sole reference; no copy needed
        else:
            internal, patches = cached
        return ({f: v.copy() for f, v in internal.items()},
                {n: {f: v.copy() for f, v in t.items()}
                 for n, t in patches.items()})

    def resample(self, rng: np.random.Generator) -> None:
        """Redraw every case's point subsample from the cached full tables.

        Shapes, labels and patch layout are unchanged (identical static
        shapes per the FoamData invariant), so device programs compiled for
        the previous sample run the fresh one without recompilation. The
        reference samples once on instantiation (foam_dataset.py:100);
        periodic resampling during long trainings exposes more of each
        case's stored field and measurably improves held-out accuracy.

        The first call re-parses each case once and starts caching the
        pristine parses; later rounds are IO-free.
        """
        self._cache_parses = True
        self.rng = rng
        self.data = [self.load_case(str(c)) for c in self.samples]

    def load_case(self, case_dir: str) -> FoamData:
        internal, patches = self._parsed_case(case_dir)
        self.normalize(internal)
        for t in patches.values():
            self.normalize(t)

        patches = self.sample_boundary(patches)
        internal = self.sample_internal(internal)

        variable = (self.get_variable_boundaries(patches)
                    if self.variable_boundaries else {})

        self.add_features(internal, patches)

        # column order: fields (from the internal table, which accumulates
        # add_features extras), then variable columns last
        n_int = len(internal["C"])
        n_bnd = sum(len(t["C"]) for t in patches.values())
        columns: dict[str, int] = {f: v.shape[1] for f, v in internal.items()}
        for f, v in variable.items():
            columns[f] = v.shape[1]

        blocks = []
        for f in internal:
            bnd = np.concatenate([t[f] for t in patches.values()]) \
                if f in next(iter(patches.values())) else \
                np.zeros((n_bnd, internal[f].shape[1]))
            blocks.append(np.concatenate([internal[f], bnd]))
        for f, v in variable.items():
            blocks.append(np.concatenate([np.zeros((n_int, v.shape[1])), v]))
        data = np.concatenate(blocks, axis=1).astype(np.float32)

        domain = {"internal": np.arange(n_int),
                  "boundary": np.arange(n_bnd) + n_int}
        off = n_int
        for name, t in patches.items():
            n = len(t["C"])
            domain[name] = np.arange(off, off + n)
            off += n
        if self.n_obs > 0:
            domain["obs"] = self.sample_obs(n_int)
        domain = {k: v.astype(np.int32) for k, v in domain.items()}

        return FoamData(data, self.build_labels(columns), domain)

    def stacked(self) -> FoamData:
        """All cases stacked (C, N, D) over numpy arrays on the host."""
        data = np.stack([c.data for c in self.data])
        dom = {k: np.stack([c.domain[k] for c in self.data])
               for k in self.data[0].domain}
        return FoamData(data, self.data[0].labels, dom)
