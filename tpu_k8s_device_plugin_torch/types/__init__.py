"""The port's contract layer: the ``DeviceImpl`` interface the plugin
adapter delegates to, and the NVIDIA constants (its own copies of the
JAX package's ``types/`` names, with NVIDIA values where they name the
hardware)."""

from . import constants
from .api import DeviceImpl, DevicePluginContext

__all__ = ["DeviceImpl", "DevicePluginContext", "constants"]
