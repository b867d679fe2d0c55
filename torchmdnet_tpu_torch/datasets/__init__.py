"""Datasets (counterpart of ``torchmdnet_tpu/datasets/__init__.py``): the
same 26 names, so that ``--dataset`` offers the same choices.

Samples are plain dicts of numpy arrays.  Nothing is downloaded: a
dataset whose raw files are missing raises an error naming them (place
them under ``root/raw``, or where the dataset's docstring says).
"""

from torchmdnet_tpu_torch.datasets.ace import Ace, AceHF
from torchmdnet_tpu_torch.datasets.ani import ANI1, ANI1CCX, ANI1X, ANI2X
from torchmdnet_tpu_torch.datasets.comp6 import (
    ANIMD, COMP6v1, COMP6v2, DrugBank, GDB07to09, GDB10to13, S66X8,
    Tripeptides)
from torchmdnet_tpu_torch.datasets.custom import Custom
from torchmdnet_tpu_torch.datasets.genentech import GenentechTorsions
from torchmdnet_tpu_torch.datasets.hdf import HDF5
from torchmdnet_tpu_torch.datasets.maceoff import MACEOFF
from torchmdnet_tpu_torch.datasets.md17 import MD17
from torchmdnet_tpu_torch.datasets.md22 import MD22
from torchmdnet_tpu_torch.datasets.mdcath import MDCATH
from torchmdnet_tpu_torch.datasets.memdataset import MemmappedDataset
from torchmdnet_tpu_torch.datasets.qm9 import QM9
from torchmdnet_tpu_torch.datasets.qm9q import QM9q
from torchmdnet_tpu_torch.datasets.spice import SPICE
from torchmdnet_tpu_torch.datasets.water import WaterBox

# the names the JAX package registers and the port does not build: none
NOT_PORTED = ()

__all__ = [
    "Ace",
    "AceHF",
    "ANIMD",
    "ANI1",
    "ANI1CCX",
    "ANI1X",
    "ANI2X",
    "COMP6v1",
    "COMP6v2",
    "Custom",
    "DrugBank",
    "GDB07to09",
    "GDB10to13",
    "GenentechTorsions",
    "HDF5",
    "MACEOFF",
    "MD17",
    "MD22",
    "MDCATH",
    "MemmappedDataset",
    "QM9",
    "QM9q",
    "SPICE",
    "S66X8",
    "Tripeptides",
    "WaterBox",
]
