"""Hand-written Hopper kernels of the port, their plain PyTorch twins and
their any-shape wrappers (``ops``)."""
