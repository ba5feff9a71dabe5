from .cartesian import CartesianGeometry, NoGeometry
from .stretched import StretchedCartesianGeometry

__all__ = ["CartesianGeometry", "NoGeometry", "StretchedCartesianGeometry"]


def geometry_from_id(geometry_id: int):
    """Map a serialized geometry_id back to its class (reference geometry_id
    constants: No=0, Cartesian=1, Stretched=2)."""
    return {
        NoGeometry.geometry_id: NoGeometry,
        CartesianGeometry.geometry_id: CartesianGeometry,
        StretchedCartesianGeometry.geometry_id: StretchedCartesianGeometry,
    }[geometry_id]
