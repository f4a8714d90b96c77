"""Data parallelism over ``torch.distributed`` (``mmdgan_tpu/parallel``)."""

from mmdgan_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    make_mesh,
    make_mesh_2d,
)
