"""Molecular dynamics on the port's potentials."""

from torchmdnet_tpu_torch.md.integrators import MDState, make_md_step

__all__ = ["MDState", "make_md_step"]
