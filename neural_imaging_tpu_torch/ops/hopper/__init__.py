"""Hand-written Hopper kernels: nvcc build (``_build``) and the bound wrappers."""
