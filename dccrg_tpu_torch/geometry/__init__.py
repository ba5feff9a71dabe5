from .cartesian import CartesianGeometry, NoGeometry
from .stretched import StretchedCartesianGeometry

__all__ = ["CartesianGeometry", "NoGeometry", "StretchedCartesianGeometry"]
