"""densityflows_tpu — a JAX normalizing-flow density-estimation engine.

JAX/XLA framework with the capabilities of the reference
``gaetanfacchinetti/DensityFlows.jl`` (surveyed in SURVEY.md):

- functional pytree layers with static masks (no macros, no mutation),
- row-major ``(batch..., d)`` layout, batch axis sharded on a device mesh,
- one jitted program per entry point (train step, sampling sweep, density),
- a whole-chain fold kernel for bulk inference on the GPU
  (``ops.pallas_chain``),
- data-parallel training via GSPMD NamedSharding + XLA collectives.

Public API parity map (reference export → here) in README.md.
"""

from .axes import CouplingAxes, coupling_axes, reverse_axes, is_reverse
from .data import (
    DataArrays,
    DataPartition,
    MetaData,
    dflt_theta,
    maximum_theta,
    minimum_theta,
    normalize_input,
    number_conditions,
    number_dimensions,
    resize_output,
)
from .models.blocks import CouplingBlock, coupling_block
from .models.chains import FlowChain, concatenate, flow_chain
from .models.autoregressive import MAFLayer, maf_layer, IAFLayer, iaf_layer
from .models.distributions import (
    BoxUniform, DiagNormal, GaussianMixture, StandardNormal,
)
from .models.flow import Flow, nll_loss
from .models.layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
    RQSCouplingLayer,
    cast_conditioners,
    coupling_layer,
)
from .models.normalization import (
    NormalizationLayer,
    normalization_layer,
    PermutationLayer,
    permutation_layer,
    LogitLayer,
    logit_layer,
)
from .models.glow import (
    ActNormLayer,
    actnorm_layer,
    InvertibleLinearLayer,
    invertible_linear_layer,
)
from .models.embedding import EmbeddedChain, embed_conditions
from .ops.coupling import (
    nice_backward,
    nice_forward,
    rnvp_backward,
    rnvp_forward,
)
from .ops.mlp import MLP, apply_mlp, init_mlp
from .train import train, evaluate, make_train_step, Adam, adam
from .data_stream import StreamingLoader, train_streaming
from .ensemble import EnsembleFlow, train_ensemble, stack_models
from .inference import (
    SMCState,
    clear_caches,
    effective_sample_size,
    fit_posterior,
    fit_posterior_apt,
    fit_posterior_rounds,
    fit_variational,
    flow_mcmc,
    make_weighted_train_step,
    mcmc_diagnostics,
    run_smc,
    sample_with_rejection,
    sbc_ranks,
    sbc_uniformity,
    smc_step,
    systematic_resample,
    weighted_nll_loss,
)
from .utils.checkpoint import (
    save_flow, load_flow, save_element, load_element,
    save_ensemble, load_ensemble, register_element,
)
from .utils.config import (
    NetConfig, DataConfig, TrainConfig, FlowConfig, build_flow, run_experiment,
)

__version__ = "0.1.0"


def summarize(obj) -> str:
    """Pretty-print any flow element / chain / flow / data container
    (reference ``summarize``, src/DensityFlows.jl:57 and per-type
    methods)."""
    return obj.summarize()

__all__ = [
    # axes
    "CouplingAxes", "coupling_axes", "reverse_axes", "is_reverse",
    # data
    "DataArrays", "DataPartition", "MetaData", "dflt_theta",
    "minimum_theta", "maximum_theta", "normalize_input", "resize_output",
    "number_dimensions", "number_conditions",
    # ops
    "MLP", "init_mlp", "apply_mlp",
    "rnvp_forward", "rnvp_backward", "nice_forward", "nice_backward",
    # models
    "RNVPCouplingLayer", "NICECouplingLayer", "RQSCouplingLayer",
    "JointRNVPCouplingLayer",
    "coupling_layer", "cast_conditioners",
    "NormalizationLayer", "normalization_layer",
    "PermutationLayer", "permutation_layer",
    "MAFLayer", "maf_layer", "IAFLayer", "iaf_layer",
    "ActNormLayer", "actnorm_layer",
    "InvertibleLinearLayer", "invertible_linear_layer",
    "EmbeddedChain", "embed_conditions",
    "CouplingBlock", "coupling_block",
    "FlowChain", "flow_chain", "concatenate",
    "StandardNormal", "DiagNormal", "GaussianMixture", "BoxUniform",
    "LogitLayer", "logit_layer",
    "Flow", "nll_loss",
    # training
    "train", "evaluate", "make_train_step", "Adam", "adam",
    "StreamingLoader", "train_streaming",
    "EnsembleFlow", "train_ensemble", "stack_models",
    # inference engine
    "sample_with_rejection", "weighted_nll_loss", "make_weighted_train_step",
    "fit_posterior", "fit_posterior_apt", "fit_posterior_rounds", "fit_variational",
    "effective_sample_size", "systematic_resample",
    "SMCState", "smc_step", "run_smc",
    "flow_mcmc", "mcmc_diagnostics", "sbc_ranks", "sbc_uniformity",
    "clear_caches",
    "summarize",
    # persistence
    "save_flow", "load_flow", "save_element", "load_element",
    "register_element",
    "save_ensemble", "load_ensemble",
    # config
    "NetConfig", "DataConfig", "TrainConfig", "FlowConfig",
    "build_flow", "run_experiment",
]
