"""The port's data and training harness against the JAX package on the
CPU: splits, batch packing, the shuffled loader and the DataModule give
the JAX package's batches on the same dataset and seed; the masked
losses, ReduceLROnPlateau and EarlyStopping match JAX's; and
``Trainer(potential, hp, DataModule(hp, dataset=ds)).fit()`` then
``.test()`` runs two epochs, writes ``metrics.csv`` with the JAX
trainer's columns and checkpoints that reload with ``strict=True``."""

import csv
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, one_torch_thread  # noqa: F401
from torchmdnet_tpu.data import collate as jcollate
from torchmdnet_tpu.data import splits as jsplits
from torchmdnet_tpu.data.datamodule import DataModule as JaxDataModule
from torchmdnet_tpu.train import loss as jloss
from torchmdnet_tpu.train import trainer as jtrainer
from torchmdnet_tpu_torch.data import collate, splits
from torchmdnet_tpu_torch.data.datamodule import DataModule
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.train import loss, trainer
from torchmdnet_tpu_torch.train.trainer import Trainer, read_checkpoint
from utils_dummy import DummyDataset

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _hparams(log_dir, **kw):
    """``tests/test_trainer.py``'s hyperparameters, with tabulated
    filters (T=16)."""
    hp = dict(
        model="tensornet", embedding_dimension=16, num_layers=1, num_rbf=8,
        rbf_type="expnorm", trainable_rbf=False, activation="silu",
        cutoff_lower=0.0, cutoff_upper=5.0, max_z=100, max_num_neighbors=16,
        derivative=True, prior_model=None, output_model="Scalar",
        reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
        atom_filter=-1, tabulated_edge_mlp=16, batch_size=4,
        inference_batch_size=4, lr=1e-3, lr_patience=5, lr_min=1e-7,
        lr_factor=0.5, lr_warmup_steps=2, weight_decay=0.0, y_weight=1.0,
        neg_dy_weight=1.0, train_loss="mse_loss", ema_alpha_y=1.0,
        ema_alpha_neg_dy=1.0, num_epochs=2, save_interval=1,
        early_stopping_patience=30, seed=0, train_size=12, val_size=4,
        test_size=4, log_dir=str(log_dir), standardize=False, dataset=None,
        splits=None)
    hp.update(kw)
    return hp


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("sizes", [(0.6, 0.2, None), (12, 4, 4),
                                   (0.75, 0.15, 0.1), (None, 3, 0.3)])
def test_splits_match_jax(sizes, tmp_path):
    want = jsplits.make_splits(37, *sizes, seed=5)
    got = splits.make_splits(37, *sizes, seed=5,
                             filename=str(tmp_path / "splits.npz"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    loaded = splits.make_splits(37, None, 1, 1, seed=0,
                                splits=str(tmp_path / "splits.npz"))
    for a, b in zip(loaded, want):
        np.testing.assert_array_equal(a, b)


def test_pad_samples_match_jax():
    ds = DummyDataset(num_samples=6)
    samples = [ds[i] for i in range(5)]
    want = jcollate.pad_samples(samples, max_atoms=64, max_mols=6)
    got = collate.pad_samples(samples, max_atoms=64, max_mols=6)
    _assert_batches_equal([got], [want])
    assert (got["batch"][sum(len(s["z"]) for s in samples):] == 6).all()


def test_loader_shuffles_by_epoch_like_jax():
    ds = DummyDataset(num_samples=23)
    kw = dict(batch_size=5, shuffle=True, seed=3)
    jl, tl = jcollate.PaddedLoader(ds, **kw), collate.PaddedLoader(ds, **kw)
    assert tl.max_atoms == jl.max_atoms and len(tl) == len(jl)
    epochs = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        _assert_batches_equal(list(tl), list(jl))
        epochs.append(next(iter(tl))["z"])
    assert not np.array_equal(*epochs)


def test_datamodule_matches_jax(tmp_path):
    hp = _hparams(tmp_path, inference_batch_size=3)
    ds = DummyDataset(num_samples=20)
    jdm, tdm = JaxDataModule(hp, dataset=ds), DataModule(hp, dataset=ds)
    jdm.setup("fit")
    tdm.setup("fit")
    for stage in ("train", "val", "test"):
        _assert_batches_equal(list(getattr(tdm, f"{stage}_dataloader")()),
                              list(getattr(jdm, f"{stage}_dataloader")()))


def test_named_dataset_raises(tmp_path):
    """Named datasets are built since the data slice: one whose raw files
    are absent raises naming them (nothing is downloaded), and one whose
    parser is not ported yet raises naming its ROADMAP item."""
    with pytest.raises(RuntimeError, match="gdb9.tar.gz"):
        DataModule(_hparams(tmp_path, dataset="QM9",
                            dataset_root=str(tmp_path),
                            dataset_arg={"label": "energy_U0"})).setup("fit")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 18"):
        DataModule(_hparams(tmp_path, dataset="MD22",
                            dataset_root=str(tmp_path))).setup("fit")


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "huber_loss"])
def test_masked_losses_match_jax(name):
    rng = np.random.RandomState(0)
    pred, target = rng.randn(2, 10, 3).astype(np.float32) * 2
    mask = rng.rand(10) > 0.4
    want = jloss.LOSS_FUNCTIONS[name](jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(mask))
    got = loss.LOSS_FUNCTIONS[name](torch.from_numpy(pred),
                                    torch.from_numpy(target),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    empty = loss.LOSS_FUNCTIONS[name](torch.from_numpy(pred),
                                      torch.from_numpy(target),
                                      torch.zeros(10, dtype=torch.bool))
    assert float(empty) == 0.0


def test_plateau_and_early_stopping_match_jax():
    metrics = [1.0, 0.9, 0.95, 0.9, 0.89995, 0.91, 0.92, 0.5, 0.6, 0.7, 0.8,
               0.8, 0.8, 0.49, 0.9, 0.9]
    kw = dict(factor=0.5, patience=2, min_lr=1e-3, cooldown=1)
    jp, tp = jtrainer.ReduceLROnPlateau(**kw), trainer.ReduceLROnPlateau(**kw)
    je, te = jtrainer.EarlyStopping(4), trainer.EarlyStopping(4)
    lr_j = lr_t = 0.1
    for m in metrics:
        lr_j, lr_t = jp.step(m, lr_j), tp.step(m, lr_t)
        assert lr_t == lr_j
        assert te.step(m) == je.step(m)
    assert lr_t < 0.1


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("fit")
    hp = _hparams(log_dir)
    ds = DummyDataset(num_samples=20)
    pot = create_model(hp, device="cpu", seed=0)
    tr = Trainer(pot, hp, DataModule(hp, dataset=ds))
    tr.dm.setup("fit")
    tr.fit()
    return hp, ds, pot, tr, tr.test()


def test_fit_writes_jax_metrics_columns(fitted):
    """The columns the JAX trainer writes (``trainer.py:339-375``): epoch,
    lr, the train losses, then y / neg_dy / total for l1 and the train
    loss; one row per epoch and the test row."""
    hp = fitted[0]
    with open(os.path.join(hp["log_dir"], "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == [
        "epoch", "lr", "train_total_mse_loss", "train_y_mse_loss",
        "train_neg_dy_mse_loss", "val_y_l1_loss", "val_neg_dy_l1_loss",
        "val_total_l1_loss", "val_y_mse_loss", "val_neg_dy_mse_loss",
        "val_total_mse_loss"]
    assert len(rows) == 1 + hp["num_epochs"] + 1
    assert all(np.isfinite(float(v)) for row in rows[1:3] for v in row)
    assert np.isfinite(fitted[4]["test_y_l1_loss"])
    assert np.isfinite(fitted[4]["test_neg_dy_l1_loss"])


def test_checkpoints_reload_strict(fitted):
    hp, ds, pot, tr, _ = fitted
    names = sorted(os.listdir(hp["log_dir"]))
    epochs = [n for n in names if n.startswith("epoch=")
              and n.endswith(".ckpt")]
    assert len(epochs) == hp["num_epochs"] and "best.ckpt" in names
    assert all(n + ".native" in names for n in epochs + ["best.ckpt"])
    assert all(f"-{tr.monitor}=" in n for n in epochs)
    sd, hp_saved = read_checkpoint(os.path.join(hp["log_dir"], "best.ckpt"))
    assert hp_saved["embedding_dimension"] == hp["embedding_dimension"]
    fresh = create_model(hp_saved, device="cpu", seed=7)
    fresh.module.load_state_dict(sd, strict=True)
    s = ds[0]
    n = len(s["z"])
    args = (s["z"], s["pos"], np.zeros(n, np.int64))
    y0, f0 = fresh.apply(*args)
    assert torch.isfinite(y0).all() and f0.shape == (n, 3)
    # the last epoch's checkpoint holds the trained weights
    last = max(epochs, key=lambda n: int(n.split("-")[0][6:]))
    sd_last, _ = read_checkpoint(os.path.join(hp["log_dir"], last))
    fresh.module.load_state_dict(sd_last, strict=True)
    y1, f1 = fresh.apply(*args)
    y2, f2 = pot.apply(*args)
    np.testing.assert_allclose(y1.numpy(), y2.detach().numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f1.numpy(), f2.detach().numpy(), rtol=RTOL,
                               atol=ATOL)


def test_sidecar_holds_the_resume_state(fitted):
    """The ``.native`` sidecar holds what a resume needs besides the
    weights and the hyperparameters, which the ``.ckpt`` holds."""
    hp, _, _, tr, _ = fitted
    side = torch.load(os.path.join(hp["log_dir"], "best.ckpt.native"),
                      weights_only=False)
    assert set(side) == {"optimizer", "step", "base_lr", "ema_y",
                         "ema_neg_dy"}
    assert side["step"] > 0 and side["optimizer"]["state"]


def test_eval_builds_no_weight_gradient(fitted, monkeypatch):
    """The val and test passes run the tabulated filter and its force
    backward (rows 5 and 7) with the weights' gradients off, so the
    coefficient gradient (row 6, ``cheb_project``) is never formed; the
    gradients are on again after."""
    from torchmdnet_tpu_torch.ops import cheb_filter as cf

    _, _, pot, tr, _ = fitted
    calls = {"filter_fwd": 0, "filter_dot_fwd": 0, "project_fwd": 0}
    for name in calls:
        def counted(*a, _f=getattr(cf, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(cf, name, counted)
    tr.test()
    assert calls["filter_fwd"] > 0 and calls["filter_dot_fwd"] > 0
    assert calls["project_fwd"] == 0
    assert all(p.requires_grad for p in pot.module.parameters())


def test_prefetch_matches_sync(tmp_path):
    """``num_workers > 0`` feeds the steps from the prefetch thread; the
    metrics are the same as without it."""
    rows = {}
    for tag, workers in (("sync", 0), ("prefetch", 2)):
        hp = _hparams(tmp_path / tag, num_workers=workers, num_epochs=1,
                      tabulated_edge_mlp=0)
        pot = create_model(hp, device="cpu", seed=0)
        tr = Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
        tr.dm.setup("fit")
        tr.fit()
        rows[tag] = open(tmp_path / tag / "metrics.csv").read()
    assert rows["sync"] == rows["prefetch"]


@pytest.mark.parametrize("option", [dict(ngpus=2), dict(wandb_use=True)])
def test_unported_options_raise(option, tmp_path, monkeypatch):
    """Data parallelism raises naming its ROADMAP item.  ``wandb_use``,
    which raised so until the loggers were ported, works as the JAX
    trainer's (``trainer.py:160-178``), whether or not ``wandb`` is
    installed: without the package (an import that fails) a warning and
    no logger; with it (a stand-in module recording its calls) ``init``
    with the run's project and name, one extra logger, and each epoch's
    row reaching ``wandb.log``."""
    hp = _hparams(tmp_path, num_epochs=1, tabulated_edge_mlp=0, **option)
    pot = create_model(hp, device="cpu", seed=0)
    if "ngpus" in option:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
        return
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.warns(UserWarning, match="wandb is not installed"):
        tr = Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
    assert tr.extra_loggers == []
    inits, rows = [], []
    stand_in = types.ModuleType("wandb")
    stand_in.init = lambda **kw: inits.append(kw)
    stand_in.log = rows.append
    monkeypatch.setitem(sys.modules, "wandb", stand_in)
    tr = Trainer(pot, dict(hp, wandb_project="p", wandb_name="n"),
                 DataModule(hp, dataset=DummyDataset(20)))
    assert len(tr.extra_loggers) == 1
    assert [(i["project"], i["name"], i["id"]) for i in inits] == [
        ("p", "n", None)]
    tr.dm.setup("fit")
    tr.fit()
    assert rows and all("train_total_mse_loss" in r for r in rows)
    assert any("val_total_mse_loss" in r for r in rows)


def test_tensorboard_logger(tmp_path):
    """``tensorboard_use``: one event file in the log directory holding
    each epoch row's numbers as scalars (JAX ``trainer.py:179-200``);
    where the package is missing, a warning and no logger."""
    hp = _hparams(tmp_path, tensorboard_use=True, num_epochs=1,
                  tabulated_edge_mlp=0)
    pot = create_model(hp, device="cpu", seed=0)
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
    except ImportError:
        with pytest.warns(UserWarning, match="tensorboard is not installed"):
            Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
        return
    tr = Trainer(pot, hp, DataModule(hp, dataset=DummyDataset(20)))
    tr.dm.setup("fit")
    tr.fit()
    events = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    assert len(events) == 1
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(tmp_path / events[0]))
    acc.Reload()
    assert "train_total_mse_loss" in acc.Tags()["scalars"]
    assert "val_total_mse_loss" in acc.Tags()["scalars"]


def _val_losses(tmp_path, ibs, package):
    """The val loss of the JAX trainer (``package`` "jax") or of the port's
    on DummyDataset with ``inference_batch_size=ibs`` (``batch_size`` 4):
    its metrics, or the exception it raised."""
    from torchmdnet_tpu.models.model import create_model as jax_create_model

    log_dir = tmp_path / f"{package}{ibs}"
    log_dir.mkdir()
    hp = _hparams(log_dir, inference_batch_size=ibs)
    ds = DummyDataset(num_samples=20)
    if package == "port":
        dm = DataModule(hp, dataset=ds)
        dm.setup("fit")
        tr = Trainer(create_model(hp, device="cpu", seed=0), hp, dm)
        return tr.test(loader=dm.val_dataloader())
    jdm = JaxDataModule(hp, dataset=ds)
    jdm.setup("fit")
    jtr = jtrainer.Trainer(jax_create_model(hp), hp, jdm)
    try:
        jtr._init_state(next(iter(jdm.train_dataloader())))
        return jtr.test(loader=jdm.val_dataloader())
    except Exception as exc:  # what JAX does is the record here
        return exc


@pytest.mark.parametrize("ibs", [2, 6])
def test_eval_batches_of_another_size(tmp_path, ibs):
    """``inference_batch_size != batch_size``.  The JAX trainer evaluates
    every val/test batch with ``num_mols = batch_size``
    (``trainer.py:233``, ``:288-294``), so the batch's ``ibs`` energy
    targets do not reshape onto its ``batch_size`` predictions and it
    raises.  The port evaluates each batch with its own molecule count
    (its ``mol_mask``) and keeps that behaviour, recorded in ROADMAP
    Queue 3: the val molecules' energy loss is the one of
    ``ibs = batch_size`` (4 molecules in batches of equal size), and with
    one batch (``ibs = 6``) the force loss too."""
    want = _val_losses(tmp_path, ibs, "jax")
    assert isinstance(want, TypeError) and "reshape" in str(want)
    got = _val_losses(tmp_path, ibs, "port")
    ref = _val_losses(tmp_path, 4, "port")
    assert all(np.isfinite(v) for v in got.values())
    np.testing.assert_allclose(got["test_y_l1_loss"], ref["test_y_l1_loss"],
                               rtol=1e-6)
    if ibs == 6:
        np.testing.assert_allclose(got["test_neg_dy_l1_loss"],
                                   ref["test_neg_dy_l1_loss"], rtol=1e-6)
