"""Tensor ops of the port: plain PyTorch, plus the wrappers of the
hand-written CUDA kernels (``radial_embedding``, ``edge_mlp``,
``blocked_q``, ``windowed_coulomb``)."""
