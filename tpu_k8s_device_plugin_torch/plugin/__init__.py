"""Kubelet-facing plugin adapter (the port's copy of the JAX package's
``plugin/``)."""

from .plugin import GpuDevicePlugin, PluginMetrics

__all__ = ["GpuDevicePlugin", "PluginMetrics"]
