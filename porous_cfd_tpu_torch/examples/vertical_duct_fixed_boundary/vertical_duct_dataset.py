"""The vertical duct's dataset (the port's counterpart of
``examples/vertical_duct_fixed_boundary/vertical_duct_dataset.py``): the
second, top inlet's one-hot boundary id is folded into the main inlet's, so
a model of the single-inlet schema (4 boundary ids) takes the two-inlet
duct and can be fine-tuned on it."""
from __future__ import annotations

from porous_cfd_tpu_torch.data.dataset import FoamDataset


class VerticalDuctDataset(FoamDataset):
    def add_features(self, internal, patches):
        super().add_features(internal, patches)
        if "inlet-top" not in self._boundary_names:
            return
        names = self._boundary_names
        i_top = names.index("inlet-top")
        i_in = names.index("inlet")
        keep = [i for i in range(len(names)) if i != i_top]
        for table in [internal, *patches.values()]:
            bid = table["boundaryId"]
            bid[:, i_in] = bid[:, i_in] + bid[:, i_top]
            table["boundaryId"] = bid[:, keep]
        self._boundary_names = [n for n in names if n != "inlet-top"]
