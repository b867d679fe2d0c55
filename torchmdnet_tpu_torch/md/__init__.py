"""Molecular dynamics on the port's potentials, and the TorchMD and ASE
adapters."""

from torchmdnet_tpu_torch.md.calculators import External, TMDNETCalculator
from torchmdnet_tpu_torch.md.integrators import (
    MDState, make_adaptive_md_step, make_md_step, run_md)

__all__ = ["External", "MDState", "TMDNETCalculator", "make_md_step",
           "make_adaptive_md_step", "run_md"]
