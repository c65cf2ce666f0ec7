"""Lie-group geometry core: SO(3), SE(3), Sim(3), closed-form alignment.

JAX replacement for the reference's Sophus + Converter layer."""

from . import align, se3, sim3, so3
from .se3 import SE3
from .sim3 import Sim3

__all__ = ["so3", "se3", "sim3", "align", "SE3", "Sim3"]
