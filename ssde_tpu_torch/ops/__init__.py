"""PyTorch ops of the port: the hand-written CUDA kernels with their plain
twins (``conv3x3``, built by ``build``), and the plain tensor ops around
them (``image``, ``geometry``)."""
