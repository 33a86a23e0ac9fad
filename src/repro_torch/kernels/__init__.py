"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``), the public wrappers (``ops``) and the nvcc build (``build``)."""
