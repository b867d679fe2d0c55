"""DataModule (counterpart of ``torchmdnet_tpu/data/datamodule.py``,
reference ``torchmdnet/data.py:18-176``) for a dataset given in memory:
splits with ``splits.npz``, cached padded loaders and the (deprecated)
``standardize`` mean/std, with the atomref energies taken out under the
Atomref prior.  Datasets named in the hyperparameters are not ported
yet."""

import os
import warnings
from typing import Optional

import numpy as np

from torchmdnet_tpu_torch.data.collate import PaddedLoader
from torchmdnet_tpu_torch.data.splits import make_splits
from torchmdnet_tpu_torch.datasets.memdataset import Subset


class DataModule:
    def __init__(self, hparams: dict, dataset=None):
        self.hparams = dict(hparams)
        self._mean = None
        self._std = None
        self._loaders = {}
        self.dataset = dataset

    def setup(self, stage: Optional[str] = None):
        hp = self.hparams
        if self.dataset is None:
            raise NotImplementedError(
                f"dataset={hp.get('dataset')!r}: named datasets are not "
                "ported yet (ROADMAP Queue 1 item 18, 'Data'); pass "
                "dataset=")
        split_file = (os.path.join(hp["log_dir"], "splits.npz")
                      if hp.get("log_dir") else None)
        self.idx_train, self.idx_val, self.idx_test = make_splits(
            len(self.dataset), hp["train_size"], hp["val_size"],
            hp["test_size"], hp["seed"], split_file, hp.get("splits"))
        print(f"train {len(self.idx_train)}, val {len(self.idx_val)}, "
              f"test {len(self.idx_test)}")
        self.train_dataset = Subset(self.dataset, self.idx_train)
        self.val_dataset = Subset(self.dataset, self.idx_val)
        self.test_dataset = Subset(self.dataset, self.idx_test)
        if hp.get("standardize"):
            warnings.warn("The standardize option is deprecated and will be "
                          "removed in the future.", DeprecationWarning)
            self._standardize()

    @property
    def atomref(self):
        if hasattr(self.dataset, "get_atomref"):
            return self.dataset.get_atomref()
        return None

    @property
    def mean(self):
        return self._mean

    @property
    def std(self):
        return self._std

    def _loader(self, dataset, stage):
        if stage not in self._loaders:
            hp = self.hparams
            bs = (hp["batch_size"] if stage == "train"
                  else hp.get("inference_batch_size", hp["batch_size"]))
            self._loaders[stage] = PaddedLoader(
                dataset, batch_size=bs, shuffle=(stage == "train"),
                seed=hp.get("seed", 0),
                max_atoms=hp.get("max_num_atoms_per_batch"))
        return self._loaders[stage]

    def train_dataloader(self):
        return self._loader(self.train_dataset, "train")

    def val_dataloader(self):
        return self._loader(self.val_dataset, "val")

    def test_dataloader(self):
        return self._loader(self.test_dataset, "test")

    def _standardize(self):
        """Mean and standard deviation of the train energies, less the
        atomref energies under the Atomref prior (reference
        ``data.py:146-176``, JAX ``:128-160``)."""
        atomref = (self.atomref if self.hparams.get("prior_model") == "Atomref"
                   else None)
        ys = []
        for i in self.idx_train:
            sample = self.dataset[int(i)]
            if sample.get("y") is None:
                warnings.warn(
                    "Standardize is true but failed to compute dataset mean "
                    "and standard deviation. Maybe the dataset only contains "
                    "forces.")
                return
            y = float(np.asarray(sample["y"]).reshape(()))
            if atomref is not None:
                y -= float(np.asarray(atomref).reshape(-1)[
                    np.asarray(sample["z"]).reshape(-1)].sum())
            ys.append(y)
        ys = np.asarray(ys)
        self._mean = float(ys.mean())
        self._std = float(ys.std(ddof=1))
