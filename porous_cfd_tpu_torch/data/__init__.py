from porous_cfd_tpu_torch.data.foam_data import FoamData  # noqa: F401
