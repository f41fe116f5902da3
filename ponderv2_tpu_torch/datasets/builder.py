"""DATASETS registry (reference: ``ponder/datasets/builder.py:10-15``)."""

from ..utils.registry import Registry

DATASETS = Registry("datasets")


def build_dataset(cfg):
    return DATASETS.build(cfg)
