"""Fixed-BC 2D case generator (the port's counterpart of
``examples/duct_fixed_boundary/generator_2d_fixed.py``).

``Generator2DFixed``'s behavior — rotation/scale grid augmentation of the 11
primitive porous shapes and one template instantiation per generated mesh —
is exactly the base class's (Blender-free linear transforms)."""
from porous_cfd_tpu_torch.datagen.generator import Generator2DBase


class Generator2DFixed(Generator2DBase):
    pass
