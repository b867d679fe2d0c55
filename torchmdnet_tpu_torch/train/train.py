"""The ``tmdnet-train-torch`` CLI (counterpart of ``torchmdnet_tpu/train/
train.py``, reference ``torchmdnet/scripts/train.py:182-279``): the
config → ``DataModule`` → the priors from the dataset → the model with the
dataset's mean and std → ``Trainer.fit`` → a test with the best
checkpoint's weights.

    tmdnet-train-torch --conf examples/TensorNet-rMD17.yaml \\
        --dataset-root <dir with raw/rmd17/npz_data/rmd17_aspirin.npz>

``--load-model ckpt`` restarts from a checkpoint: its weights, and from its
``.native`` sidecar the optimizer state, the step, the base LR and the
loss EMAs, unless ``--reset-trainer`` (JAX ``:53-80``).  Training runs on
the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU (there is
no flag for the device).  ``--ngpus N`` (or -1) trains data-parallel on N
of this host's cards, one process each (``train/trainer.py``);
``--num-nodes N`` joins N hosts at ``MASTER_ADDR``:``MASTER_PORT``, this
one as ``NODE_RANK``.
"""

import os


def main(argv=None, device=None):
    """Train as the command line ``argv`` (default ``sys.argv[1:]``) says,
    on ``device`` (default: the CUDA card; raises where there is none);
    returns the test metrics."""
    import numpy as np
    import torch

    from torchmdnet_tpu_torch.data.datamodule import DataModule
    from torchmdnet_tpu_torch.models.model import (
        create_model, create_prior_models, load_model)
    from torchmdnet_tpu_torch.train.trainer import Trainer, read_checkpoint
    from torchmdnet_tpu_torch.utils.config import get_args

    args = get_args(argv)
    # the open --conf file is no hyperparameter (input.yaml leaves it out)
    hp = {k: v for k, v in vars(args).items() if k != "conf"}
    if int(hp.get("num_nodes", 1) or 1) > 1:
        # several hosts meet at MASTER_ADDR:MASTER_PORT (JAX :30-35 calls
        # jax.distributed.initialize() here); the trainer's launch joins
        # this host's ranks there (parallel/dp.py)
        from torchmdnet_tpu_torch.parallel.dp import env_init_method

        env_init_method()
    seed = int(hp.get("seed", 1) or 0)
    np.random.seed(seed)
    torch.manual_seed(seed)

    data = DataModule(hp)
    data.setup("fit")
    prior_models = create_prior_models(hp, data.dataset)
    if hp.get("remove_ref_energy"):
        # delta learning: a trailing disabled Atomref (reference
        # scripts/train.py:198)
        from torchmdnet_tpu_torch.priors import Atomref

        prior_models = tuple(prior_models) + (
            Atomref(initial_atomref=data.atomref, enable=False),)

    if hp.get("load_model"):
        potential = load_model(hp["load_model"], args=hp, device=device)
        trainer = Trainer(potential, hp, data)
        trainer._init_state()
        sidecar = str(hp["load_model"]) + ".native"
        if os.path.exists(sidecar) and not hp.get("reset_trainer"):
            trainer.restore(torch.load(sidecar, map_location=potential.device,
                                       weights_only=True))
    else:
        potential = create_model(hp, prior_models=prior_models,
                                 mean=data.mean, std=data.std,
                                 device=device, seed=seed)
        trainer = Trainer(potential, hp, data)

    trainer.fit()

    # the test with the best checkpoint's weights (reference :271-279)
    best = os.path.join(hp["log_dir"], "best.ckpt")
    if os.path.exists(best):
        sd, _ = read_checkpoint(best)
        trainer.potential.module.load_state_dict(sd)
    results = trainer.test()
    print("test results:", results)
    return results


if __name__ == "__main__":
    main()
