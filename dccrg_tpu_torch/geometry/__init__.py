from .cartesian import CartesianGeometry, NoGeometry

__all__ = ["CartesianGeometry", "NoGeometry"]
