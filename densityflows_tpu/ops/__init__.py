"""Transform kernels: the jnp path + the whole-chain Pallas fold kernel."""
