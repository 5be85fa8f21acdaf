"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the ``use_kernel`` entry points (``ops``)."""
