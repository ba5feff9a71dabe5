from .advection import Advection

__all__ = ["Advection"]
