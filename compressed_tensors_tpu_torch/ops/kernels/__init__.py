"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Importing a module here builds nothing: the CUDA library is built
on the first launch (see ``_build``)."""
