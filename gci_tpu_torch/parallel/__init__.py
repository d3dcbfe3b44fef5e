"""The mesh of positions and the multi-process runtime of the port
(counterpart of ``gci_tpu.parallel``): ``mesh`` lays a (dp, gp) grid over
the process's devices, ``distributed`` holds the process identity and the
``torch.distributed`` group."""
from .mesh import make_mesh, pad_to_multiple

__all__ = ["make_mesh", "pad_to_multiple"]
