"""Plugin lifecycle manager (the port's copy of the JAX package's
``manager/``)."""

from .manager import PluginManager

__all__ = ["PluginManager"]
