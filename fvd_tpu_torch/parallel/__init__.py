"""The multi-device layer: the counterpart of ``fvd_tpu/parallel/``."""

from fvd_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
