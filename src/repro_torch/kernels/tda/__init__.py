"""TDA attention: hand-written CUDA kernels, their plain versions, and the
dense reference."""
