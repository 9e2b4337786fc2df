"""The duct_fixed_boundary_hard experiment: composed multi-primitive porous
obstacles, the duct_fixed_boundary zoo and pipeline with the hard loss
weights."""
