"""Backbone model zoo: the ``dense`` and ``ssm`` families' forward pass
(``layers``, ``transformer``, ``ssm``, ``model``)."""
from .model import build_model  # noqa: F401
