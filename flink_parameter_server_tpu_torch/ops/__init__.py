"""Device ops: the two CUDA kernels of the main path and the plain-torch
helpers around them."""
