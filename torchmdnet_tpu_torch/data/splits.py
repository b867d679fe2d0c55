"""Train/val/test splits (counterpart of ``torchmdnet_tpu/data/splits.py``,
reference ``torchmdnet/utils.py:181-266``): sizes may be fractions
(rounded), counts, or None (the remainder, at most one); float rounding
overflow shaves the float-specified split; splits load from and save to
``splits.npz``.  The same seed gives the same indices as the JAX package
(``np.random.default_rng(seed).permutation``)."""

import warnings

import numpy as np


def train_val_test_split(dset_len, train_size, val_size, test_size, seed,
                         order=None):
    if (train_size is None) + (val_size is None) + (test_size is None) > 1:
        raise ValueError("Only one of train_size, val_size, test_size is "
                         "allowed to be None.")
    is_float = (isinstance(train_size, float), isinstance(val_size, float),
                isinstance(test_size, float))
    train_size = round(dset_len * train_size) if is_float[0] else train_size
    val_size = round(dset_len * val_size) if is_float[1] else val_size
    test_size = round(dset_len * test_size) if is_float[2] else test_size

    if train_size is None:
        train_size = dset_len - val_size - test_size
    elif val_size is None:
        val_size = dset_len - train_size - test_size
    elif test_size is None:
        test_size = dset_len - train_size - val_size

    if train_size + val_size + test_size > dset_len:
        if is_float[2]:
            test_size -= 1
        elif is_float[1]:
            val_size -= 1
        elif is_float[0]:
            train_size -= 1

    if min(train_size, val_size, test_size) < 0:
        raise ValueError(
            f"One of training ({train_size}), validation ({val_size}) or "
            f"testing ({test_size}) splits ended up with a negative size.")
    total = train_size + val_size + test_size
    if total > dset_len:
        raise ValueError(f"The dataset ({dset_len}) is smaller than the "
                         f"combined split sizes ({total}).")
    if total < dset_len:
        warnings.warn(f"{dset_len - total} samples were excluded from the "
                      "dataset")

    idxs = np.arange(dset_len, dtype=int)
    if order is None:
        idxs = np.random.default_rng(seed).permutation(idxs)
    idx_train = idxs[:train_size]
    idx_val = idxs[train_size:train_size + val_size]
    idx_test = idxs[train_size + val_size:total]
    if order is not None:
        idx_train = [order[i] for i in idx_train]
        idx_val = [order[i] for i in idx_val]
        idx_test = [order[i] for i in idx_test]
    return np.array(idx_train), np.array(idx_val), np.array(idx_test)


def make_splits(dataset_len, train_size, val_size, test_size, seed,
                filename=None, splits=None, order=None):
    if splits is not None:
        loaded = np.load(splits)
        idx_train, idx_val, idx_test = (loaded["idx_train"],
                                        loaded["idx_val"], loaded["idx_test"])
    else:
        idx_train, idx_val, idx_test = train_val_test_split(
            dataset_len, train_size, val_size, test_size, seed, order)
    if filename is not None:
        np.savez(filename, idx_train=idx_train, idx_val=idx_val,
                 idx_test=idx_test)
    return idx_train, idx_val, idx_test
