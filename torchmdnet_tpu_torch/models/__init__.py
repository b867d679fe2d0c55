"""Models of the port (TensorNet2 with the Coulomb head)."""
