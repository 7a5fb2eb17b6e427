"""Node labeller: publishes GPU properties as Kubernetes node labels
(the port's counterpart of the JAX package's ``labeller/``): a generator
map computes labels from discovery, a small stdlib API-server client
applies them, and a reconcile controller keeps them fresh."""

from .controller import NodeLabelController, label_delta
from .generators import LABEL_GENERATORS, LabelContext, generate_labels
from .k8s_client import NodeClient

__all__ = [
    "LABEL_GENERATORS",
    "LabelContext",
    "NodeClient",
    "NodeLabelController",
    "generate_labels",
    "label_delta",
]
