"""Datasets (counterpart of ``torchmdnet_tpu/datasets/__init__.py``): the
same 26 names, so that ``--dataset`` offers the same choices.

Samples are plain dicts of numpy arrays.  Nothing is downloaded: a
dataset whose raw files are missing raises an error naming them (place
them under ``root/raw``).  The 13 names of the parsers not ported yet
(the eight COMP6 sets, MD22, MDCATH, QM9q, WaterBox and GenentechTorsions)
raise ``NotImplementedError`` when built.
"""

from torchmdnet_tpu_torch.datasets.ace import Ace, AceHF
from torchmdnet_tpu_torch.datasets.ani import ANI1, ANI1CCX, ANI1X, ANI2X
from torchmdnet_tpu_torch.datasets.custom import Custom
from torchmdnet_tpu_torch.datasets.hdf import HDF5
from torchmdnet_tpu_torch.datasets.maceoff import MACEOFF
from torchmdnet_tpu_torch.datasets.md17 import MD17
from torchmdnet_tpu_torch.datasets.memdataset import MemmappedDataset
from torchmdnet_tpu_torch.datasets.qm9 import QM9
from torchmdnet_tpu_torch.datasets.spice import SPICE

NOT_PORTED = ("ANIMD", "COMP6v1", "COMP6v2", "DrugBank", "GDB07to09",
              "GDB10to13", "Tripeptides", "S66X8", "MD22", "MDCATH", "QM9q",
              "WaterBox", "GenentechTorsions")


def _not_ported_dataset(name):
    def build(*args, **kwargs):
        from torchmdnet_tpu_torch.models.model import _not_ported

        _not_ported(f"dataset {name}", "Queue 1 item 18(b), 'The named "
                    "parsers'")
    build.__name__ = build.__qualname__ = name
    return build


globals().update({name: _not_ported_dataset(name) for name in NOT_PORTED})

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
