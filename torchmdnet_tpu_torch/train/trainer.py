"""Training orchestration (counterpart of ``torchmdnet_tpu/train/
trainer.py``; reference ``torchmdnet/module.py``, ``scripts/train.py:
182-279``):

* the epoch loop over padded static-shape batches, one train step each
  (``train/step.py``), optionally fed by a prefetch thread;
* the val loop recording l1 and train-loss metrics with the reference's
  ``{stage}_{type}_{loss}`` names, means over the epoch, and the periodic
  test pass;
* ReduceLROnPlateau on the monitored metric (torch's mode-min semantics),
  LR warmup inside the step, EarlyStopping;
* ``metrics.csv`` (an existing one is kept under a timestamped name),
  and with ``wandb_use``/``tensorboard_use`` the W&B and TensorBoard
  loggers (JAX ``trainer.py:157-200``), imported when asked for, with a
  warning and nothing else where the package is missing;
* checkpoints ``epoch=…-<monitor>=….ckpt`` (the best ten kept) and
  ``best.ckpt``, each the whole model in the reference's Lightning layout
  (``utils/checkpoint.py::save_checkpoint``: the ``model.``-prefixed
  state dict, the buffers upstream keeps, ``model.mean``/``model.std``
  and the hyperparameters), beside a ``.native`` sidecar with the
  optimizer state, step and base LR;
* ``load_weights``: a checkpoint's weights, after the compat remaps,
  loaded into the model before the optimizer state is made (JAX
  ``trainer.py:242-255``).

Everything runs on the potential's device (CUDA unless it was built with
``device="cpu"``), batches in the potential's dtype.  Data parallelism
(JAX ``trainer.py:212-229``, ``:273-285``, ``:301-330``): ``ngpus`` cards
(-1: every visible one; otherwise ``min(max(ngpus, 1), available)``, so
that more than the host has clamps to what it has, one on the CPU),
each a process with a replica (``parallel/dp.py``).  ``fit`` in a process
outside a process group launches them, and afterwards loads rank 0's
final weights and optimizer state; a process already in a group of
several (the CLI's launch, or a caller's) trains as its rank.  Each rank
steps on its share of each group of loader batches, the steps average
their gradients and losses, a last group too small for every rank is
dropped with a warning (``dropped_batches``), the validation and test
metrics are rank 0's, and only rank 0 writes logs and checkpoints.
Fewer train batches than cards: one card, with JAX's warning.
"""

import copy
import csv
import os
import queue
import tempfile
import threading
import time
import warnings
from collections import defaultdict
from typing import Optional

import torch

from torchmdnet_tpu_torch.models.model import Potential, prior_specs
from torchmdnet_tpu_torch.parallel import dp
from torchmdnet_tpu_torch.train.step import (
    TrainState, batch_losses, create_train_state, make_train_step)
from torchmdnet_tpu_torch.utils.checkpoint import (
    CKPT_PREFIX, RBF_BUFFERS, apply_reference_compat, is_skipped,
    load_weights, read_torch_checkpoint, save_checkpoint)


def prefetch_to_device(iterator, size=2):
    """Run ``iterator`` in a background thread, keeping up to ``size``
    items queued, so that host-side packing overlaps the device step; an
    exception in the thread is raised in the consumer."""
    q = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    errors = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as exc:  # handed to the consumer below
            errors.append(exc)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if errors:
                raise errors[0]
            return
        yield item


class CSVLogger:
    """``metrics.csv`` in ``log_dir``; a pre-existing file is renamed with
    a timestamp (reference ``utils.py:408-417``)."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.csv")
        if os.path.exists(self.path):
            os.rename(self.path, self.path + f".bak-{int(time.time())}")
        self._fieldnames = None

    def log(self, metrics: dict):
        if self._fieldnames is None and os.path.exists(self.path):
            # a file the ranks of a data-parallel fit wrote: append
            with open(self.path, newline="") as fh:
                self._fieldnames = next(csv.reader(fh), None)
        write_header = self._fieldnames is None
        if write_header:
            self._fieldnames = list(metrics.keys())
        with open(self.path, "a", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=self._fieldnames,
                                    extrasaction="ignore")
            if write_header:
                writer.writeheader()
            writer.writerow(metrics)


def extra_loggers(hp: dict, log_dir) -> list:
    """The opt-in loggers of ``hp`` as callables on a metrics row (JAX
    ``trainer.py:157-200``, reference ``scripts/train.py:229-246``): W&B
    (``wandb_use``; project, name and resume id from ``hp``) and
    TensorBoard (``tensorboard_use``: each number of a row a scalar at
    the row's epoch, in ``log_dir``).  Each package is imported here; a
    missing one gives a warning and no logger."""
    out = []
    if hp.get("wandb_use"):
        try:
            import wandb
        except ImportError:
            warnings.warn("wandb_use=True but wandb is not installed")
        else:
            resume = hp.get("wandb_resume_from_id")
            wandb.init(project=hp.get("wandb_project", "training_"),
                       name=hp.get("wandb_name", "training"), id=resume,
                       resume="must" if resume else None, config=hp)
            out.append(wandb.log)
    if hp.get("tensorboard_use"):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            warnings.warn(
                "tensorboard_use=True but tensorboard is not installed")
        else:
            writer = SummaryWriter(log_dir)

            def tb_log(row):
                step = int(row.get("epoch", 0))
                for key, value in row.items():
                    if isinstance(value, (int, float)):
                        writer.add_scalar(key, value, step)
                writer.flush()

            out.append(tb_log)
    return out


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau, mode min, on the host: an epoch counts as
    an improvement only when the metric beats ``best`` by ``threshold``
    (relative by default), and ``cooldown`` epochs after a reduction
    reset the bad-epoch count (reference ``module.py:131-137``)."""

    def __init__(self, factor=0.8, patience=10, min_lr=1e-6,
                 threshold=1e-4, threshold_mode="rel", cooldown=0):
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"unknown threshold_mode {threshold_mode!r}")
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = float("inf")
        self.bad_epochs = 0

    def _is_better(self, metric):
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric, lr):
        """The LR for the next epoch after ``metric``."""
        if self._is_better(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_epochs = 0
        if self.bad_epochs > self.patience:
            self.cooldown_counter = self.cooldown
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr


class EarlyStopping:
    def __init__(self, patience=30):
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric):
        """True when training should stop after ``metric``."""
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs >= self.patience


def read_checkpoint(path):
    """``(state dict with the port's keys, hyperparameters)`` of a
    checkpoint this trainer wrote; the state dict loads into
    ``create_model(hp, ...).module`` with ``strict=True``.  The buffers
    outside the port's state dict are left out: the skipped ones (the
    priors' tables, ``model.mean``/``model.std``), the frozen rbf buffers
    (with ``trainable_rbf`` they are parameters and stay) and a
    non-trainable Atomref's table.  ``models/model.py::load_model`` reads
    the whole model, those included."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    hp = ckpt["hyper_parameters"]
    # trainable rbf tensors are parameters of the state dict
    rbf = () if hp.get("trainable_rbf") else RBF_BUFFERS
    tables = {f"prior_model.{i}.atomref.weight"
              for i, (name, arg) in enumerate(prior_specs(hp))
              if name == "Atomref" and not (arg or {}).get("trainable")}
    sd = {}
    for k, v in ckpt["state_dict"].items():
        k = k[len(CKPT_PREFIX):]
        if not (is_skipped(k) or k in tables
                or k.rsplit(".", 1)[-1] in rbf):
            sd[k] = v
    return sd, hp


def _fit_rank(rank, world_size, model, hp, datamodule, device_type,
              final_path, final_rank):
    """One rank of a data-parallel ``fit`` launched by :class:`Trainer`:
    the replica ``model`` (a :class:`Potential`'s fields, on the CPU)
    moved to this rank's device and trained; rank ``final_rank`` (this
    host's first) saves the final weights and optimizer state to
    ``final_path``."""
    module, derivative, hparams, dtype = model
    dev = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    pot = Potential(module.to(dev), dev, derivative=derivative,
                    hparams=hparams, dtype=dtype)
    trainer = Trainer(pot, hp, datamodule)
    trainer.fit()
    if rank == final_rank:
        st = trainer.state
        torch.save({"state_dict": pot.module.state_dict(),
                    "optimizer": st.optimizer.state_dict(),
                    "step": st.step, "base_lr": st.base_lr,
                    "ema_y": float(st.ema_y),
                    "ema_neg_dy": float(st.ema_neg_dy),
                    "dropped_batches": trainer.dropped_batches}, final_path)


class Trainer:
    def __init__(self, potential, hparams: dict, datamodule):
        hp = dict(hparams)
        self.potential = potential
        self.device = potential.device
        self.hp = hp
        self.dm = datamodule
        # data parallelism (JAX trainer.py:212-216): -1 = every card there
        # is, otherwise as many as asked and the host has; a process of a
        # group of several trains as its rank
        self.rank, self.world_size = dp.world()
        ngpus = int(hp.get("ngpus", 1) or 1)
        avail = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        self.n_devices = (self.world_size if self.world_size > 1
                          else avail if ngpus == -1
                          else min(max(ngpus, 1), avail))
        self.dropped_batches = 0  # remainder batches dropped this run
        self.log_dir = hp.get("log_dir", "logs")
        self.logger = CSVLogger(self.log_dir) if self.rank == 0 else None
        self.extra_loggers = (extra_loggers(hp, self.log_dir)
                              if self.rank == 0 else [])
        self.plateau = ReduceLROnPlateau(factor=hp.get("lr_factor", 0.8),
                                         patience=hp.get("lr_patience", 10),
                                         min_lr=hp.get("lr_min", 1e-6))
        self.early = EarlyStopping(hp.get("early_stopping_patience", 30))
        self.train_loss = hp.get("train_loss", "mse_loss")
        self.monitor = hp.get("checkpoint_monitor",
                              f"val_total_{self.train_loss}")
        self.best_ckpts = []  # (metric, path), the best ten kept
        self.best_metric = float("inf")
        self.state: Optional[TrainState] = None
        self._train_step = None

    # -- setup -------------------------------------------------------------
    def _init_state(self):
        hp = self.hp
        if hp.get("load_weights"):
            hparams, sd = read_torch_checkpoint(hp["load_weights"])
            load_weights(self.potential.module,
                         apply_reference_compat(sd, hp, hparams, {}))
        self.state = create_train_state(
            self.potential, lr=hp["lr"],
            weight_decay=hp.get("weight_decay", 0.0))
        make_step = (dp.make_data_parallel_train_step if self.world_size > 1
                     else make_train_step)
        self._train_step = make_step(
            self.potential, num_mols=int(hp["batch_size"]),
            y_weight=hp.get("y_weight", 1.0),
            neg_dy_weight=hp.get("neg_dy_weight", 1.0),
            lr_warmup_steps=hp.get("lr_warmup_steps", 0),
            ema_alpha_y=hp.get("ema_alpha_y", 1.0),
            ema_alpha_neg_dy=hp.get("ema_alpha_neg_dy", 1.0),
            train_loss=self.train_loss,
            gradient_clipping=hp.get("gradient_clipping", 0.0) or 0.0)

    def restore(self, saved: dict):
        """Continue from a checkpoint's ``.native`` sidecar (what
        :meth:`_save_checkpoint` writes): the optimizer state, the step,
        the base LR and the loss EMAs."""
        if self.state is None:
            self._init_state()
        st = self.state
        st.optimizer.load_state_dict(saved["optimizer"])
        st.step = int(saved["step"])
        st.base_lr = float(saved["base_lr"])
        dev = st.ema_y.device
        st.ema_y = torch.tensor(float(saved["ema_y"]), device=dev)
        st.ema_neg_dy = torch.tensor(float(saved["ema_neg_dy"]), device=dev)

    def _to_device_batch(self, batch):
        dev = self.device
        out = {}
        for key, v in batch.items():
            if key in ("z", "batch"):
                out[key] = torch.as_tensor(v, device=dev).long()
            elif key == "mol_mask":
                out[key] = torch.as_tensor(v, device=dev)
            else:
                out[key] = torch.as_tensor(v, dtype=self.potential.dtype,
                                           device=dev)
        return out

    def _eval(self, db, names):
        """``{loss name: (loss_y, loss_neg_dy)}`` of one batch, from one
        energy+forces evaluation (the JAX trainer evaluates once per loss
        name; the values are the same).  The weights' gradients are off
        meanwhile, so that the force pass builds no gradient in them (in
        the tabulated filters: no row-6 ``cheb_project``)."""
        num_mols = int(db["mol_mask"].shape[0])
        module = self.potential.module
        module.requires_grad_(False)
        try:
            y, neg_dy = self.potential.apply(
                db["z"], db["pos"], db["batch"], num_mols=num_mols,
                box=db.get("box"), q=db.get("q"),
                extra_args=db.get("extra_args"))
        finally:
            module.requires_grad_(True)
        return {name: tuple(v.detach() for v in batch_losses(
            name, y, neg_dy, db, num_mols)) for name in names}

    @staticmethod
    def _mean(values):
        return float(torch.stack(values).mean())

    # -- data parallelism --------------------------------------------------
    def _single_device_fallback(self, train_loader):
        """One device where a step group would lack batches (JAX
        ``trainer.py:219-229``): True when the fit must run alone."""
        n_batches = len(train_loader)
        if self.n_devices > 1 and n_batches < self.n_devices:
            warnings.warn(f"only {n_batches} train batches per epoch < "
                          f"{self.n_devices} devices; running "
                          "single-device")
            self.n_devices = 1
        return self.n_devices == 1

    def _fit_launched(self):
        """``fit`` on ``n_devices`` new processes (``parallel/dp.py::
        launch``), then rank 0's final weights and optimizer state here."""
        module = copy.deepcopy(self.potential.module).cpu()
        model = (module, self.potential.derivative, self.potential.hparams,
                 self.potential.dtype)
        num_nodes = int(self.hp.get("num_nodes", 1) or 1)
        first = (int(os.environ.get("NODE_RANK", 0)) * self.n_devices
                 if num_nodes > 1 else 0)
        with tempfile.TemporaryDirectory() as tmp:
            final_path = os.path.join(tmp, "final.pt")
            dp.launch(_fit_rank, self.n_devices, model, self.hp, self.dm,
                      self.device.type, final_path, first,
                      device_type=self.device.type, num_nodes=num_nodes)
            final = torch.load(final_path, map_location=self.device,
                               weights_only=True)
        self.potential.module.load_state_dict(final["state_dict"])
        self.state = None
        self.restore(final)
        self.dropped_batches = final["dropped_batches"]
        return self.state

    def _dropped(self, count):
        self.dropped_batches += count
        warnings.warn(
            f"data-parallel epoch dropped {count} remainder batch(es) "
            f"(< {self.world_size} device group); {self.dropped_batches} "
            "dropped so far this run")

    def _train_batches(self, train_loader):
        """This rank's train batches: its share of each group of
        ``world_size`` (:func:`parallel.dp.shard_batch`), or all of them
        on one device or where the group lacks batches."""
        if self.world_size == 1 or self.n_devices == 1:
            return iter(train_loader)
        return dp.shard_batch(train_loader, self.rank, self.world_size,
                              self._dropped)

    # -- loops -------------------------------------------------------------
    def fit(self):
        hp = self.hp
        train_loader = self.dm.train_dataloader()
        val_loader = self.dm.val_dataloader()
        # in a group that lacks batches every rank steps on all of them
        # (averaging identical gradients), so the replicas stay in step
        alone = self._single_device_fallback(train_loader)
        if self.world_size == 1 and (
                not alone or int(hp.get("num_nodes", 1) or 1) > 1):
            return self._fit_launched()
        if self.state is None:
            self._init_state()
        y_w = hp.get("y_weight", 1.0)
        negdy_w = hp.get("neg_dy_weight", 1.0)
        num_epochs = hp.get("num_epochs", 300)
        names = ("l1_loss", self.train_loss)

        for epoch in range(num_epochs):
            train_loader.set_epoch(epoch)
            tmetrics = defaultdict(list)
            last_lr = self.state.base_lr
            batches = (self._to_device_batch(b)
                       for b in self._train_batches(train_loader))
            n_prefetch = int(hp.get("num_workers", 0) or 0)
            if n_prefetch > 0:
                batches = prefetch_to_device(batches, size=min(n_prefetch, 4))
            for batch in batches:
                self.state, metrics = self._train_step(self.state, batch)
                for key in ("loss", "loss_y", "loss_neg_dy"):
                    tmetrics[key].append(metrics[key])
                last_lr = metrics["lr"]
            vmetrics = defaultdict(list)
            for batch in val_loader:
                for name, (ly, lneg) in self._eval(
                        self._to_device_batch(batch), names).items():
                    vmetrics[f"y_{name}"].append(ly)
                    vmetrics[f"neg_dy_{name}"].append(lneg)
                    vmetrics[f"total_{name}"].append(y_w * ly + negdy_w * lneg)

            row = {"epoch": float(epoch), "lr": float(last_lr)}
            for key in ("loss", "loss_y", "loss_neg_dy"):
                kind = "total" if key == "loss" else key[5:]
                row[f"train_{kind}_{self.train_loss}"] = self._mean(
                    tmetrics[key])
            for key, vals in vmetrics.items():
                row[f"val_{key}"] = self._mean(vals)

            # the periodic in-training test pass (reference
            # module.py:161-177)
            test_interval = hp.get("test_interval", -1) or -1
            if test_interval > 0 and epoch > 0 and epoch % test_interval == 0:
                row.update(self._test_metrics(self.dm.test_dataloader()))
            if self.world_size > 1:
                # rank 0's metrics decide the LR, the checkpoints and the
                # stop on every rank
                rows = [row]
                torch.distributed.broadcast_object_list(rows, src=0)
                row = rows[0]
            if self.rank == 0:
                self.logger.log(row)
            for log in self.extra_loggers:
                log(row)

            monitor_val = row.get(self.monitor, row.get(
                f"val_total_{self.train_loss}",
                row[f"train_total_{self.train_loss}"]))
            lr_monitor = row.get(
                f"{hp.get('lr_metric', 'val')}_total_{self.train_loss}",
                monitor_val)
            self.state.base_lr = self.plateau.step(lr_monitor,
                                                   self.state.base_lr)

            save_interval = hp.get("save_interval", 10)
            if ((epoch + 1) % max(save_interval, 1) == 0
                    or epoch == num_epochs - 1):
                self._save_checkpoint(epoch, monitor_val)
            self._save_checkpoint(epoch, monitor_val, best_only=True)

            if self.early.step(monitor_val):
                print(f"Early stopping at epoch {epoch}")
                break
            if self.state.base_lr < hp.get("lr_min", 1e-6):
                print(f"LR below lr_min at epoch {epoch}; stopping")
                break
        return self.state

    def _test_metrics(self, loader):
        metrics = defaultdict(list)
        for batch in loader:
            ly, lneg = self._eval(self._to_device_batch(batch),
                                  ("l1_loss",))["l1_loss"]
            metrics["test_y_l1_loss"].append(ly)
            metrics["test_neg_dy_l1_loss"].append(lneg)
        return {k: self._mean(v) for k, v in metrics.items()}

    def test(self, loader=None):
        if self.state is None:
            self._init_state()
        out = self._test_metrics(loader or self.dm.test_dataloader())
        if self.rank == 0:
            self.logger.log({"epoch": -1.0, "lr": 0.0, **out})
        return out

    # -- checkpoints ---------------------------------------------------------
    def _save_checkpoint(self, epoch, monitor_val, best_only=False):
        if self.rank != 0:
            return
        if best_only:
            if monitor_val >= self.best_metric:
                return
            self.best_metric = monitor_val
            path = os.path.join(self.log_dir, "best.ckpt")
        else:
            path = os.path.join(
                self.log_dir,
                f"epoch={epoch}-{self.monitor}={monitor_val:.6f}.ckpt")
        save_checkpoint(path, self.potential, hparams=self.hp)
        # the sidecar: what an exact resume needs besides the weights
        torch.save({"optimizer": self.state.optimizer.state_dict(),
                    "step": self.state.step, "base_lr": self.state.base_lr,
                    "ema_y": float(self.state.ema_y),
                    "ema_neg_dy": float(self.state.ema_neg_dy)},
                   path + ".native")
        if best_only:
            return
        self.best_ckpts.append((monitor_val, path))
        self.best_ckpts.sort(key=lambda t: t[0])
        for _, old in self.best_ckpts[10:]:
            for f in (old, old + ".native"):
                if os.path.exists(f):
                    os.remove(f)
        self.best_ckpts = self.best_ckpts[:10]
