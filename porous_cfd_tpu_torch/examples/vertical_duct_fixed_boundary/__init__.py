"""The vertical_duct_fixed_boundary experiment: a duct with a second inlet
on top, fine-tuned from a duct_fixed_boundary checkpoint."""
