"""Prior models (counterpart of ``torchmdnet_tpu/priors/``)."""

from torchmdnet_tpu_torch.priors.atomref import Atomref, LearnableAtomref
from torchmdnet_tpu_torch.priors.base import BasePrior
from torchmdnet_tpu_torch.priors.coulomb import Coulomb
from torchmdnet_tpu_torch.priors.d2 import D2
from torchmdnet_tpu_torch.priors.zbl import ZBL

__all__ = ["BasePrior", "Atomref", "LearnableAtomref", "ZBL", "Coulomb", "D2"]

PRIOR_CLASSES = {name: cls for name, cls in [
    ("Atomref", Atomref),
    ("LearnableAtomref", LearnableAtomref),
    ("ZBL", ZBL),
    ("Coulomb", Coulomb),
    ("D2", D2),
]}
