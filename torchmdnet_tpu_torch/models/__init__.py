"""Models of the port: every representation of the JAX package and its
heads."""
__all_models__ = [
    "graph-network",
    "transformer",
    "equivariant-transformer",
    "tensornet",
    "tensornet2",
]
