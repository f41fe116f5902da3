"""MODELS registry (reference: ``ponder/models/builder.py:10-16``)."""

from ..utils.registry import Registry

MODELS = Registry("models")


def build_model(cfg):
    return MODELS.build(cfg)
