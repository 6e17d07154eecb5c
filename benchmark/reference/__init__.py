"""The plain float32 reference: no kernels, no JAX, nothing of the program."""
