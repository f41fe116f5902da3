"""PyTorch/CUDA port of ``ponderv2_tpu`` for one NVIDIA Hopper GPU.

This first slice is the ScanNet semantic-segmentation serving path:
``engines.test.SemSegTester`` over ``DefaultSegmentor`` + ``SpUNet-v1m1``.
Module paths and names mirror ``ponderv2_tpu`` so each module's JAX
counterpart is easy to find. The one TPU kernel on the path, the band conv
forward, is a hand-written CUDA kernel (``csrc/band_conv.cu``), built with
``nvcc`` at first use; on CPU tensors every op takes its plain PyTorch
version.
"""
