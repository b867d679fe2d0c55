"""The training CLI's flags (counterpart of ``torchmdnet_tpu/utils/
config.py``, reference ``torchmdnet/scripts/train.py:34-155`` and
``torchmdnet/utils.py:269-346``): the same ~70 flags with the same choices
and defaults, a YAML config whose values become defaults (an unknown key
is an error, the command line wins), the resolved config written as
``input.yaml``, and a restart that takes its hyperparameters from a
checkpoint.

The boolean flags keep upstream's ``type=bool``, as the JAX package does:
``bool`` of any non-empty string is True, so ``--standardize false``
turns standardization on, and only an empty string turns a flag off.
Recipes set booleans in their YAML file, where they are real booleans.

``yaml`` is imported only where a YAML file or value is read
(:class:`LoadFromFile`, :class:`LoadFromCheckpoint`'s ``hparams.yaml``,
``--box-vecs`` and ``--cells-per-dim``): ``input.yaml`` is written by
:func:`dump_yaml`, so training runs where ``yaml`` is not installed.
:func:`to_argv` turns a recipe's dict into command-line arguments for such
a machine.
"""

import argparse
import json
import math
import os


def number(text):
    """int, float, or None from the command line or a YAML file
    (reference ``utils.py:330-346``)."""
    if text is None or text == "None":
        return None
    try:
        return int(text)
    except ValueError:
        return float(text)


def _yaml_list(text):
    """A list given as YAML on the command line (``--box-vecs``,
    ``--cells-per-dim``)."""
    import yaml

    return list(yaml.safe_load(text))


class LoadFromFile(argparse.Action):
    """``--conf file.yaml``: the file's values become defaults, an unknown
    key is an error, and the command line wins (reference
    ``utils.py:269-291``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if not values.name.endswith(("yaml", "yml")):
            raise ValueError("Configuration file must end with yaml or yml")
        import yaml

        with values as f:
            config = yaml.safe_load(f)
        for key in config.keys():
            if key not in namespace:
                raise ValueError(f"Unknown argument in config file: {key}")
        if ("load_model" in config and namespace.load_model is not None
                and config["load_model"] != namespace.load_model):
            raise ValueError("Cannot use load_model in the config file and "
                             "the command line at the same time.")
        namespace.__dict__.update(config)


class LoadFromCheckpoint(argparse.Action):
    """``--load-model ckpt``: the hyperparameters of ``hparams.yaml``
    beside the checkpoint, else those inside it, for the keys the parser
    knows (reference ``utils.py:294-309``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        hparams_path = os.path.join(os.path.dirname(values), "hparams.yaml")
        if os.path.exists(hparams_path):
            import yaml

            with open(hparams_path) as f:
                config = yaml.safe_load(f)
        else:
            from torchmdnet_tpu_torch.utils.checkpoint import (
                read_torch_checkpoint)

            config, _ = read_torch_checkpoint(values)
        namespace.__dict__.update(
            {k: v for k, v in config.items() if k in namespace})
        namespace.load_model = values


def _yaml_scalar(value):
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 reads a float only with a dot in the mantissa: 1.0e-08
        if "e" in text and "." not in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, str):
        return json.dumps(value)  # a double-quoted YAML scalar
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_yaml_scalar(v)}"
                               for k, v in value.items()) + "}"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def dump_yaml(config: dict) -> str:
    """``config`` (a flat namespace: scalars, None, lists and dicts) as
    YAML that ``yaml.safe_load`` reads back to the same dict, keys sorted
    as ``yaml.dump`` sorts them; written without ``yaml``."""
    return "".join(f"{json.dumps(str(k))}: {_yaml_scalar(config[k])}\n"
                   for k in sorted(config))


def save_argparse(args, filename, exclude=None):
    """Write the resolved config (reference ``utils.py:312-327``)."""
    if not filename.endswith(("yaml", "yml")):
        raise ValueError(f"{filename}: the config file must end with yaml "
                         "or yml")
    if isinstance(exclude, str):
        exclude = [exclude]
    config = {k: v for k, v in vars(args).items() if k not in (exclude or [])}
    with open(filename, "w") as fout:
        fout.write(dump_yaml(config))


def get_argparse():
    from torchmdnet_tpu_torch import models as models_pkg
    from torchmdnet_tpu_torch.datasets import __all__ as dataset_names
    from torchmdnet_tpu_torch.models.common import ACTIVATIONS, RBF_CLASSES
    from torchmdnet_tpu_torch.models.output_modules import OUTPUT_MODULES
    from torchmdnet_tpu_torch.train.loss import LOSS_FUNCTIONS

    # fmt: off
    parser = argparse.ArgumentParser(description="Training")
    parser.add_argument('--load-model', action=LoadFromCheckpoint, help='Restart training using a model checkpoint')
    parser.add_argument('--conf', '-c', type=open, action=LoadFromFile, help='Configuration yaml file')
    parser.add_argument('--num-epochs', default=300, type=int)
    parser.add_argument('--batch-size', default=32, type=int)
    parser.add_argument('--inference-batch-size', default=None, type=int)
    parser.add_argument('--lr', default=1e-4, type=float)
    parser.add_argument('--lr-patience', type=int, default=10)
    parser.add_argument('--lr-metric', type=str, default='val', choices=['train', 'val'])
    parser.add_argument('--lr-min', type=float, default=1e-6)
    parser.add_argument('--lr-factor', type=float, default=0.8)
    parser.add_argument('--lr-warmup-steps', type=int, default=0)
    parser.add_argument('--early-stopping-patience', type=int, default=30)
    parser.add_argument('--early-stopping-monitor', type=str, default='val_total_mse_loss')
    parser.add_argument('--reset-trainer', type=bool, default=False)
    parser.add_argument('--weight-decay', type=float, default=0.0)
    parser.add_argument('--ema-alpha-y', type=float, default=1.0)
    parser.add_argument('--ema-alpha-neg-dy', type=float, default=1.0)
    parser.add_argument('--ngpus', type=int, default=-1, help='Number of devices; -1 uses all available')
    parser.add_argument('--num-nodes', type=int, default=1, help='Number of hosts')
    parser.add_argument('--precision', type=int, default=32, choices=[16, 32, 64])
    parser.add_argument('--matmul-precision', type=str, default='highest', choices=['highest', 'high', 'default'], help='float32 matmuls: highest and high are full float32, default allows TF32')
    parser.add_argument('--log-dir', '-l', default='/tmp/logs')
    parser.add_argument('--splits', default=None)
    parser.add_argument('--train-size', type=number, default=None)
    parser.add_argument('--val-size', type=number, default=0.05)
    parser.add_argument('--test-size', type=number, default=0.1)
    parser.add_argument('--test-interval', type=int, default=-1)
    parser.add_argument('--save-interval', type=int, default=10)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--num-workers', type=int, default=4)
    parser.add_argument('--redirect', type=bool, default=False)
    parser.add_argument('--gradient-clipping', type=float, default=0.0)
    parser.add_argument('--remove-ref-energy', action='store_true')
    parser.add_argument('--checkpoint-monitor', type=str, default='val_total_mse_loss')
    parser.add_argument('--load-weights', default=None, type=str)
    # dataset specific
    parser.add_argument('--dataset', default=None, type=str, choices=dataset_names)
    parser.add_argument('--dataset-root', default='~/data', type=str)
    parser.add_argument('--dataset-arg', default=None)
    parser.add_argument('--coord-files', default=None, type=str)
    parser.add_argument('--embed-files', default=None, type=str)
    parser.add_argument('--energy-files', default=None, type=str)
    parser.add_argument('--force-files', default=None, type=str)
    parser.add_argument('--dataset-preload-limit', default=1024, type=int)
    parser.add_argument('--max-num-atoms-per-batch', default=None, type=int, help='Static atom capacity of a padded batch; default = batch_size × largest molecule')
    parser.add_argument('--y-weight', default=1.0, type=float)
    parser.add_argument('--neg-dy-weight', default=1.0, type=float)
    parser.add_argument('--train-loss', default='mse_loss', type=str, choices=list(LOSS_FUNCTIONS))
    parser.add_argument('--train-loss-arg', default=None)
    # model architecture
    parser.add_argument('--model', type=str, default='graph-network', choices=models_pkg.__all_models__)
    parser.add_argument('--output-model', type=str, default='Scalar', choices=list(OUTPUT_MODULES))
    parser.add_argument('--output-mlp-num-layers', type=int, default=0)
    parser.add_argument('--prior-model', type=str, default=None, action="extend", nargs="*")
    parser.add_argument('--prior-args', default=None)
    # architectural args
    parser.add_argument('--charge', type=bool, default=False)
    parser.add_argument('--spin', type=bool, default=False)
    parser.add_argument('--embedding-dimension', type=int, default=256)
    parser.add_argument('--num-layers', type=int, default=6)
    parser.add_argument('--num-rbf', type=int, default=64)
    parser.add_argument('--activation', type=str, default='silu', choices=list(ACTIVATIONS))
    parser.add_argument('--rbf-type', type=str, default='expnorm', choices=list(RBF_CLASSES))
    parser.add_argument('--trainable-rbf', type=bool, default=False)
    parser.add_argument('--neighbor-embedding', type=bool, default=False)
    parser.add_argument('--aggr', type=str, default='add')
    # transformer specific
    parser.add_argument('--distance-influence', type=str, default='both', choices=['keys', 'values', 'both', 'none'])
    parser.add_argument('--attn-activation', default='silu', choices=list(ACTIVATIONS))
    parser.add_argument('--num-heads', type=int, default=8)
    # ET specific
    parser.add_argument('--vector-cutoff', type=bool, default=False)
    # TensorNet specific
    parser.add_argument('--equivariance-invariance-group', type=str, default='O(3)')
    parser.add_argument('--box-vecs', type=_yaml_list, default=None)
    parser.add_argument('--static_shapes', type=bool, default=True)
    # TensorNet2 / Coulomb output specific
    parser.add_argument('--q-dim', type=int, default=0)
    parser.add_argument('--q-weights', default=None)
    parser.add_argument('--coulomb-cutoff', type=number, default=None)
    parser.add_argument('--coulomb-max-num-neighbors', type=int, default=None)
    parser.add_argument('--coulomb-neighbor-strategy', type=str, default='brute')
    parser.add_argument('--coulomb-cells-per-dim', type=int, nargs=3, default=None, help='static cell grid of the Coulomb head\'s cell strategy')
    parser.add_argument('--coulomb-cell-capacity', type=int, default=64)
    # the kernels and the JAX package's performance options (all default
    # to the reference-equivalent plain paths)
    parser.add_argument('--remat', type=bool, default=False, help='Recompute the layers in the backward (large N)')
    parser.add_argument('--pallas-edge-mlp', type=bool, default=False, help='The fused edge-MLP kernel (kernels 3 and 4)')
    parser.add_argument('--tabulated-edge-mlp', type=int, default=0, help='Chebyshev terms for spectrally tabulated edge filters; 0 = exact MLP')
    parser.add_argument('--pallas-embedding', type=bool, default=False, help='The fused radial-embedding kernels (kernels 1 and 2)')
    parser.add_argument('--neighbor-strategy', type=str, default='brute', choices=['brute', 'cell'])
    parser.add_argument('--cells-per-dim', type=_yaml_list, default=None, help='Static cell grid for neighbor-strategy=cell')
    parser.add_argument('--cell-capacity', type=int, default=64)
    # other args
    parser.add_argument('--derivative', default=False, type=bool)
    parser.add_argument('--cutoff-lower', type=float, default=0.0)
    parser.add_argument('--cutoff-upper', type=float, default=5.0)
    parser.add_argument('--atom-filter', type=int, default=-1)
    parser.add_argument('--max-z', type=int, default=100)
    parser.add_argument('--max-num-neighbors', type=int, default=32)
    parser.add_argument('--standardize', type=bool, default=False)
    parser.add_argument('--reduce-op', type=str, default='add', choices=['add', 'mean'])
    parser.add_argument('--wandb-use', default=False, type=bool)
    parser.add_argument('--wandb-name', default='training', type=str)
    parser.add_argument('--wandb-project', default='training_', type=str)
    parser.add_argument('--wandb-resume-from-id', default=None, type=str)
    parser.add_argument('--tensorboard-use', default=False, type=bool)
    # fmt: on
    return parser


def get_args(argv=None):
    """The parsed namespace; ``log_dir`` is made and the resolved config
    (without ``conf``) written there as ``input.yaml``."""
    import sys

    args = get_argparse().parse_args(argv)
    if args.redirect:
        os.makedirs(os.path.abspath(args.log_dir), exist_ok=True)
        sys.stdout = open(os.path.join(args.log_dir, "log"), "w")
        sys.stderr = sys.stdout
    if args.inference_batch_size is None:
        args.inference_batch_size = args.batch_size
    os.makedirs(os.path.abspath(args.log_dir), exist_ok=True)
    save_argparse(args, os.path.join(args.log_dir, "input.yaml"),
                  exclude=["conf"])
    return args


def to_argv(config: dict, parser=None) -> list:
    """Command-line arguments that parse to ``config`` (a recipe's dict)
    on a machine without ``yaml``: each key its ``--flag`` and the value as
    text, a boolean ``"1"`` or ``""`` (``type=bool``: an empty string is
    the only False), None as ``"None"`` for the ``number`` flags, a list
    one argument an item for the flags that take several
    (``prior_model``: a single name becomes a one-item list, which the
    priors read alike), and ``dataset_arg`` as JSON, which ``DataModule``
    reads back.  Keys equal to the parser's default are left out; a value
    the command line cannot carry (another dict or list, None elsewhere)
    raises ``ValueError``."""
    parser = parser or get_argparse()
    defaults = vars(parser.parse_args([]))
    actions = {a.dest: a for a in parser._actions}
    argv = []
    for key, value in config.items():
        if key not in actions:
            raise ValueError(f"Unknown argument: {key}")
        action = actions[key]
        if (type(defaults.get(key)) is type(value)
                and defaults[key] == value):
            continue
        flag = action.option_strings[0]
        if action.nargs == 0 and value is True:  # store_true
            argv.append(flag)
        elif isinstance(value, bool) and action.nargs is None:
            argv += [flag, "1" if value else ""]
        elif value is None and action.type is number:
            argv += [flag, "None"]
        elif key == "dataset_arg" and isinstance(value, dict):
            argv += [flag, json.dumps(value)]
        elif isinstance(value, (list, tuple)) and action.nargs is not None:
            argv += [flag, *(str(v) for v in value)]
        elif isinstance(value, str) and action.nargs == "*":
            argv += [flag, value]
        elif isinstance(value, (str, int, float)):
            argv += [flag, str(value)]
        else:
            raise ValueError(f"{key}={value!r} cannot be given on the "
                             "command line; use a YAML file (--conf)")
    return argv
