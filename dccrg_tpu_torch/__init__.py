"""dccrg_tpu_torch: the PyTorch/CUDA port of dccrg_tpu.

A second package beside the JAX package ``dccrg_tpu``, which stays the
reference it is tested against.  It mirrors that package's module layout:
the host metadata modules (``core``, ``geometry``, ``parallel``, ``utils``,
``native``) are copies, and the device layers (``parallel/dense.py``,
``grid.py``, ``ops``, ``models``) are ported to PyTorch, with every Pallas
kernel on a ported path replaced by a hand-written CUDA kernel
(``csrc/``, built at first use by ``cuda_build.py``).

It never imports ``jax`` or ``dccrg_tpu``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
from .geometry import CartesianGeometry, NoGeometry, StretchedCartesianGeometry
from .grid import CellSpec, Grid
from .models import Advection, GameOfLife, Particles, Poisson, Vlasov

__all__ = ["Advection", "CartesianGeometry", "CellSpec", "GameOfLife", "Grid",
           "NoGeometry", "Particles", "Poisson", "StretchedCartesianGeometry", "Vlasov"]
