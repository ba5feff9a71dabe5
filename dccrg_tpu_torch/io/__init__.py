"""Checkpoint I/O and the VTK writer (the JAX package's ``io``)."""
from .checkpoint import load_grid_data, save_grid_data
from .vtk import write_vtk_file

__all__ = ["load_grid_data", "save_grid_data", "write_vtk_file"]
