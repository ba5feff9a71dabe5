from .mapping import ERROR_CELL, ERROR_INDEX, Mapping
from .topology import Topology

__all__ = ["ERROR_CELL", "ERROR_INDEX", "Mapping", "Topology"]
