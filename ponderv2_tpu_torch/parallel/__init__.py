"""Data parallelism over ``torch.distributed`` (counterpart of ``ponderv2_tpu/parallel``)."""
