"""Configuration dataclasses with the reference's defaults.

The reference has no config subsystem — configuration is Julia keyword
defaults scattered across constructors (SURVEY.md §5 "Config / flag
system"). These dataclasses centralize the same defaults:

- network shape: hidden 32, 2 sublayers, relu, bias on
  (/root/reference/src/Layers.jl:113-123);
- data split: f_training 0.9, f_validation 0.1
  (/root/reference/src/Data.jl:156-162);
- training: epochs 100, batch 64, shuffle on, Adam 1e-3
  (/root/reference/src/Flows.jl:380-389; test/runtests.jl:114).
"""

from __future__ import annotations

import dataclasses

__all__ = ["NetConfig", "DataConfig", "TrainConfig", "FlowConfig",
           "build_flow", "run_experiment"]


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Conditioner-MLP shape (reference src/Layers.jl:113-123)."""

    hidden_dim_s: int = 32
    hidden_dim_t: int = 32
    n_sublayers_s: int = 2
    n_sublayers_t: int = 2
    activation_s: str = "relu"
    activation_t: str = "relu"
    bias: bool = True
    # 0.0 = reference semantics; > 0 tanh-clamps the RNVP log-scale
    # (models/layers.py max_log_scale) — ignored by other families
    max_log_scale: float = 0.0
    # rnvp only: ONE two-headed conditioner emitting (s ‖ t) — half the
    # conditioner FLOPs of the split form (docs/design.md §10); False
    # keeps the reference's separate s/t nets
    joint_conditioner: bool = False

    def layer_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Split fractions (reference src/Data.jl:156-162)."""

    f_training: float = 0.9
    f_validation: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference src/Flows.jl:380-389)."""

    epochs: int = 100
    batchsize: int = 64
    shuffle: bool = True
    verbose: bool = True
    learning_rate: float = 1e-3
    mixed_precision: bool = False  # bf16 conditioner compute, f32 state
    remat: bool = False            # per-layer activation rematerialization


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """End-to-end experiment config: model + data + training.

    ``family`` selects the block type: ``'rnvp'`` (default, affine
    couplings), ``'nice'`` (additive), ``'rqs'`` (rational-quadratic
    spline couplings, ``n_bins`` knots), or ``'maf'`` (masked
    autoregressive blocks with a permutation between them).
    ``mix='linear'`` inserts a trainable LU-parameterized invertible
    linear between blocks; ``'permute'`` a fixed reversal;
    ``'none'`` nothing. ``tail`` selects the chain tail:
    ``'normalization'`` (range pin, the reference default),
    ``'actnorm'`` (trainable, data-initialized), ``'logit'`` (for
    hard-bounded data), or ``'none'``.
    """

    net: NetConfig = NetConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    n_blocks: int = 3
    family: str = "rnvp"
    mix: str = "none"
    tail: str = "normalization"
    n_bins: int = 8
    norm_alpha: float = -1.0
    norm_beta: float = 1.0


def build_flow(config: FlowConfig, data, *, key=None):
    """Construct the model from a config: ``n_blocks`` blocks of the
    selected ``family`` (each transforming every dim once), optional
    mixing layers between blocks, and the configured tail layer.
    """
    import jax

    from ..models.blocks import coupling_block
    from ..models.chains import flow_chain
    from ..models.flow import Flow
    from ..models.glow import actnorm_layer, invertible_linear_layer
    from ..models.layers import (
        NICECouplingLayer, RNVPCouplingLayer, RQSCouplingLayer,
    )
    from ..models.autoregressive import maf_layer
    from ..models.normalization import (
        logit_layer, normalization_layer, permutation_layer,
    )

    if config.family not in ("rnvp", "nice", "rqs", "maf"):
        raise ValueError(f"unknown family {config.family!r}")
    if config.mix not in ("none", "linear", "permute"):
        raise ValueError(f"unknown mix {config.mix!r}")
    if config.tail not in ("normalization", "actnorm", "logit", "none"):
        raise ValueError(f"unknown tail {config.tail!r}")
    if key is None:
        key = jax.random.key(0)
    keys = jax.random.split(key, config.n_blocks)
    d, n = data.num_dimensions, data.num_conditions

    blocks = []
    for i, k in enumerate(keys):
        if config.family == "maf":
            blocks.append(
                maf_layer(d, n=n, key=k,
                          hidden_dim=config.net.hidden_dim_t,
                          activation=config.net.activation_t)
            )
        else:
            kind = {"rnvp": RNVPCouplingLayer, "nice": NICECouplingLayer,
                    "rqs": RQSCouplingLayer}[config.family]
            blocks.append(
                coupling_block(data, None, key=k, kind=kind,
                               n_bins=config.n_bins,
                               **config.net.layer_kwargs())
            )
        last = i == config.n_blocks - 1
        if config.family == "maf" and not last:
            blocks.append(permutation_layer(d))
        elif config.mix == "linear" and not last:
            blocks.append(invertible_linear_layer(d, key=jax.random.fold_in(k, 1)))
        elif config.mix == "permute" and not last:
            blocks.append(permutation_layer(d))

    tail = {
        "normalization": lambda: [normalization_layer(
            data.x, config.norm_alpha, config.norm_beta)],
        "actnorm": lambda: [actnorm_layer(data.x)],
        "logit": lambda: [logit_layer(data.x, margin=0.01)],
        "none": lambda: [],
    }[config.tail]()
    chain = flow_chain(*blocks, *tail)
    return Flow(chain, data)


def run_experiment(config: FlowConfig, x, theta=None, *, key=None, mesh=None):
    """Data split → model build → training, all from one config.
    Returns ``(flow, data, opt_state)``."""
    import jax
    import optax

    from ..data import DataArrays
    from ..train import train

    if key is None:
        key = jax.random.key(0)
    k_model, k_train = jax.random.split(key)
    data = DataArrays.make(
        x, theta,
        f_training=config.data.f_training,
        f_validation=config.data.f_validation,
        rng=0,
    )
    flow = build_flow(config, data, key=k_model)
    optimizer = optax.adam(config.train.learning_rate)
    opt_state = train(
        flow, data, optimizer,
        epochs=config.train.epochs,
        batchsize=config.train.batchsize,
        shuffle=config.train.shuffle,
        verbose=config.train.verbose,
        key=k_train,
        mesh=mesh,
        mixed_precision=config.train.mixed_precision,
        remat=config.train.remat,
    )
    return flow, data, opt_state
