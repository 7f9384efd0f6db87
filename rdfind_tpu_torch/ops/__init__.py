"""Device primitives of the port: segment algebra, frequency, emission, the dense
sweep and its CUDA kernels."""
