"""Entry points of the port's node agents: the device plugin, the node
labeller and the metrics exporter."""
