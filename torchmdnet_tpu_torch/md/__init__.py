"""Molecular dynamics on the port's potentials."""

from torchmdnet_tpu_torch.md.integrators import (
    MDState, make_adaptive_md_step, make_md_step, run_md)

__all__ = ["MDState", "make_md_step", "make_adaptive_md_step", "run_md"]
