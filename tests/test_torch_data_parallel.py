"""Data-parallel training (``parallel/dp.py``, JAX ``parallel/dp.py``)
on the CPU: a 2-process gloo step equals one process stepping on the two
batches' averaged gradients and scalars, to 1e-6; the rank split of
``shard_batch`` and the dropped remainder; the trainer's clamp of
``ngpus`` to the devices there are, its single-device fallback and its
warning; and a ``Trainer.fit`` that launches two gloo ranks itself.
torch only: no JAX model is compiled."""

import copy
import os
import warnings

import numpy as np
import pytest
import torch

from torch_dp_workers import STEP_KW, TN_ARGS, Molecules, batch, dp_steps
from torch_parity import one_torch_thread  # noqa: F401
from torchmdnet_tpu_torch.data.datamodule import DataModule
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.parallel import dp
from torchmdnet_tpu_torch.train.step import (
    create_train_state, make_train_step)
from torchmdnet_tpu_torch.train.trainer import Trainer, read_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_two_rank_step_equals_averaged_step(tmp_path):
    """Two gloo ranks, each on its own batch, for two steps: the weights,
    the metrics and the EMAs equal one process whose step gets the mean
    of both batches' gradients, losses and EMAs (with clipping, warmup
    and EMA smoothing on), to 1e-6."""
    out = str(tmp_path / "rank0.pt")
    dp.launch(dp_steps, 2, 2, out, device_type="cpu")
    got = torch.load(out, weights_only=True)

    pot = create_model(TN_ARGS, device="cpu", seed=0)
    state = create_train_state(pot, lr=1e-2)
    metrics = []
    for s in range(2):
        # rank 1's gradients and scalars at this step, from a copy of the
        # model and state stepping on its batch
        other = {}
        twin = copy.deepcopy(state)
        twin_pot = copy.copy(pot)
        twin_pot.module = twin.module
        make_train_step(twin_pot, num_mols=3, average=lambda ts: other.update(
            ts=[t.clone() for t in ts]), **STEP_KW)(twin, batch(10 + s))

        def mean(ts):
            for t, o in zip(ts, other["ts"]):
                t.copy_((t + o) / 2)

        state, m = make_train_step(pot, num_mols=3, average=mean,
                                   **STEP_KW)(state, batch(s))
        metrics.append({k: float(v) for k, v in m.items()})
    for key, want in pot.module.state_dict().items():
        np.testing.assert_allclose(got["weights"][key], want, rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    for a, b in zip(got["metrics"], metrics):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["ema"], (float(state.ema_y),
                                            float(state.ema_neg_dy)),
                               rtol=1e-6)


def test_shard_batch():
    """Rank r takes the r-th batch of each group of ``world_size``; a last
    group too small for every rank is dropped and reported."""
    for world_size, count in ((2, 7), (3, 7), (3, 6), (1, 5), (4, 3)):
        dropped = []
        shards = [list(dp.shard_batch(range(count), r, world_size,
                                      dropped.append))
                  for r in range(world_size)]
        full = count // world_size * world_size
        for r, shard in enumerate(shards):
            assert shard == list(range(r, full, world_size))
        assert dropped == ([count - full] * world_size if count > full
                           else [])


def _hparams(log_dir, **kw):
    hp = dict(TN_ARGS, batch_size=4, inference_batch_size=4, lr=1e-3,
              lr_patience=5, lr_min=1e-7, lr_factor=0.5, lr_warmup_steps=0,
              weight_decay=0.0, y_weight=1.0, neg_dy_weight=1.0,
              train_loss="mse_loss", num_epochs=2, save_interval=1,
              early_stopping_patience=30, seed=0, train_size=20,
              val_size=4, test_size=4, log_dir=str(log_dir),
              standardize=False, dataset=None, splits=None)
    hp.update(kw)
    return hp


def test_ngpus_clamps_to_the_devices_there_are(tmp_path):
    """``min(max(ngpus, 1), available)`` and -1 = all, as JAX's trainer
    clamps (``trainer.py:212-216``): the CPU has one device."""
    for ngpus in (2, -1, 0, 1):
        hp = _hparams(tmp_path, ngpus=ngpus)
        tr = Trainer(create_model(hp, device="cpu", seed=0), hp,
                     DataModule(hp, dataset=Molecules(28)))
        assert tr.n_devices == 1 and tr.world_size == 1


def test_single_device_fallback(tmp_path):
    """Fewer train batches than devices: one device, with JAX's warning
    (``trainer.py:219-229``), and the same metrics as a run on one."""
    rows = {}
    for n in (1, 2):
        hp = _hparams(tmp_path / str(n), train_size=4, num_epochs=1)
        tr = Trainer(create_model(hp, device="cpu", seed=0), hp,
                     DataModule(hp, dataset=Molecules(12)))
        tr.dm.setup("fit")
        tr.n_devices = n
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr.fit()
        assert tr.n_devices == 1
        said = [str(w.message) for w in caught if "single-device" in
                str(w.message)]
        assert said == ([] if n == 1 else [
            "only 1 train batches per epoch < 2 devices; running "
            "single-device"])
        rows[n] = open(tmp_path / str(n) / "metrics.csv").read()
    assert rows[1] == rows[2]


def test_fit_launches_two_ranks(tmp_path):
    """``fit`` with two devices launches two gloo ranks: each epoch's five
    train batches make two steps and drop one (``dropped_batches``), only
    rank 0 writes the metrics and checkpoints, and the launching trainer
    ends with rank 0's weights and step."""
    hp = _hparams(tmp_path, num_epochs=2)
    pot = create_model(hp, device="cpu", seed=0)
    before = copy.deepcopy(pot.module.state_dict())
    tr = Trainer(pot, hp, DataModule(hp, dataset=Molecules(28)))
    tr.dm.setup("fit")
    assert len(tr.dm.train_dataloader()) == 5
    tr.n_devices = 2
    state = tr.fit()
    assert tr.dropped_batches == 2 and state.step == 4
    lines = open(tmp_path / "metrics.csv").read().splitlines()
    assert len(lines) == 3 and lines[0].startswith("epoch,lr,")
    # the launching trainer's weights are the last epoch's checkpoint
    last, = [f for f in os.listdir(tmp_path)
             if f.startswith("epoch=1-") and f.endswith(".ckpt")]
    sd, _ = read_checkpoint(str(tmp_path / last))
    for key, value in pot.module.state_dict().items():
        assert torch.equal(value, sd[key]), key
    assert any(not torch.equal(v, before[k])
               for k, v in pot.module.state_dict().items())
    out = tr.test()
    assert np.isfinite(out["test_y_l1_loss"])
    assert len(open(tmp_path / "metrics.csv").read().splitlines()) == 4
