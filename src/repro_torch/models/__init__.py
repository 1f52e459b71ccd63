"""Backbone model zoo: every family's forward pass, prefill and decode
(``layers``, ``moe``, ``transformer``, ``ssm``, ``model``)."""
from .model import build_model  # noqa: F401
