"""Coupling layers: RealNVP and NICE, plus the constructor family.

JAX counterpart of the reference layer structs and the
``CouplingLayer`` convenience-constructor family
(/root/reference/src/affine/RNVP.jl:41-48, /root/reference/src/affine/NICE.jl:31-36,
/root/reference/src/Layers.jl:110-158).

Layers are frozen pytree dataclasses: conditioner-MLP parameters are the
*data* leaves (trainable via ``jax.grad`` + optax), the
:class:`~densityflows_tpu.axes.CouplingAxes` is *static* aux data, so each
layer's masking pattern specializes the compiled program (SURVEY.md §7
"static shape/mask specialization").

Direction convention (SURVEY.md §2.4.4): ``forward`` = latent z → data x
(sampling), ``inverse`` = data x → latent z (density/training; the
reference calls this ``backward``). Both return ``(y, log_det_jac)`` with
per-sample ldj of batch shape. ``forward_`` is the ldj-free sampling fast
path (the reference's ``forward!``, src/affine/RNVP.jl:190-205) — in JAX
it is a pure function whose output buffer XLA reuses via donation in the
jitted sampling program.

Julia's ~20 ``CouplingLayer`` dispatch overloads collapse into one factory
function :func:`coupling_layer` with keyword arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from ..axes import CouplingAxes, coupling_axes
from ..ops.mlp import MLP, init_mlp, apply_mlp, count_params
from ..ops import coupling as C

__all__ = [
    "RNVPCouplingLayer", "NICECouplingLayer", "RQSCouplingLayer",
    "JointRNVPCouplingLayer",
    "coupling_layer", "cast_conditioners",
]


def cast_conditioners(model, dtype=jnp.bfloat16):
    """Cast conditioner-network parameters (every :class:`MLP` /
    ``MaskedMLP`` subtree) to ``dtype``, leaving transform constants —
    normalization/actnorm scales, LU factors, spline bounds — in their
    original precision.

    This is the mixed-precision compute cast: :func:`apply_mlp` runs its
    matmuls in the *weights'* dtype with f32 accumulation
    (ops/mlp.py), so bf16 conditioners get bf16 tensor-core passes while
    s/t/ldj and the loss stay f32 (SURVEY.md §7 "keep s/ldj accumulation
    in f32"). Used inside the loss by ``train(mixed_precision=True)`` so
    master params, grads, and optimizer state remain f32.
    """
    from ..ops.made import MaskedMLP

    def cast_net(net):
        return jax.tree_util.tree_map(
            lambda a: a.astype(dtype)
            if jnp.issubdtype(jnp.result_type(a), jnp.floating) else a,
            net,
        )

    is_net = lambda n: isinstance(n, (MLP, MaskedMLP))
    return jax.tree_util.tree_map(
        lambda n: cast_net(n) if is_net(n) else n, model, is_leaf=is_net
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RNVPCouplingLayer:
    """Real-NVP affine coupling layer (reference src/affine/RNVP.jl:41-48).

    Trainable leaves: ``s_net``, ``t_net`` (the reference's
    ``Flux.@layer ... trainable=(s_net, t_net)``, RNVP.jl:51).
    """

    s_net: MLP
    t_net: MLP
    axes: CouplingAxes = dataclasses.field(metadata=dict(static=True))
    # 0.0 = unbounded (the reference's exact semantics); > 0 soft-clamps
    # the log-scale to (−M, M) via M·tanh(s/M) — the Glow-style guard
    # against the exp(s) overflow→NaN cascade on out-of-distribution
    # inputs (SURVEY.md §7 numerics; reference mitigation is only the
    # trailing NormalizationLayer, docs/src/documentation.md:61)
    max_log_scale: float = dataclasses.field(
        metadata=dict(static=True), default=0.0)

    def _conditioner(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        h = C.nn_input(y_id, theta)
        s = apply_mlp(self.s_net, h)
        if self.max_log_scale:
            m = self.max_log_scale
            s = m * jnp.tanh(s / m)
        return y_id, y_af, s, apply_mlp(self.t_net, h)

    def forward(self, z, theta):
        """latent → data with ldj (reference ``forward``, RNVP.jl:168-187)."""
        z_id, z_af, s, t = self._conditioner(z, theta)
        x_af, ldj = C.rnvp_forward(s, t, z_af)
        return C.recombine_features(z_id, x_af, self.axes), ldj

    def inverse(self, x, theta):
        """data → latent with ldj (reference ``backward``, RNVP.jl:150-165)."""
        x_id, x_af, s, t = self._conditioner(x, theta)
        z_af, ldj = C.rnvp_backward(s, t, x_af)
        return C.recombine_features(x_id, z_af, self.axes), ldj

    def forward_(self, z, theta):
        """ldj-free sampling fast path (reference ``forward!``, RNVP.jl:190-205)."""
        z_id, z_af, s, t = self._conditioner(z, theta)
        return C.recombine_features(z_id, z_af * jnp.exp(s) + t, self.axes)

    def summarize(self) -> str:
        return (
            f"RNVPCouplingLayer | s_net > {list(self.s_net.dims)} "
            f"({count_params(self.s_net)} parameters)\n"
            f"                  | t_net > {list(self.t_net.dims)} "
            f"({count_params(self.t_net)} parameters)\n"
            f"                  | axes  > {self.axes.summarize()}"
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JointRNVPCouplingLayer:
    """Real-NVP coupling layer with a TWO-HEADED conditioner: ONE MLP
    emits ``(s ‖ t)`` instead of separate s/t networks.

    Same coupling math as :class:`RNVPCouplingLayer` (reference
    src/affine/RNVP.jl:77-96, 168-187) — the difference is purely how
    the conditioner is parameterized. The reference keeps separate
    ``s_net``/``t_net`` (RNVP.jl:41-48) and the split
    :class:`RNVPCouplingLayer` preserves that for parity; this form is
    the standard RealNVP/Glow choice: half the matmul count per layer,
    and the narrow matmuls (first layer K = n+|id|, last layer N = |af|)
    occur once per layer instead of twice, with the last head twice as
    wide (N = 2|af|).

    Build with ``coupling_layer(..., joint_conditioner=True)``.
    """

    st_net: MLP
    axes: CouplingAxes = dataclasses.field(metadata=dict(static=True))
    # tanh soft-clamp of the log-scale; 0.0 = unbounded (see
    # RNVPCouplingLayer.max_log_scale)
    max_log_scale: float = dataclasses.field(
        metadata=dict(static=True), default=0.0)

    def _conditioner(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        h = C.nn_input(y_id, theta)
        out = apply_mlp(self.st_net, h)
        a = self.axes.transform_dim
        s, t = out[..., :a], out[..., a:]
        if self.max_log_scale:
            m = self.max_log_scale
            s = m * jnp.tanh(s / m)
        return y_id, y_af, s, t

    def forward(self, z, theta):
        z_id, z_af, s, t = self._conditioner(z, theta)
        x_af, ldj = C.rnvp_forward(s, t, z_af)
        return C.recombine_features(z_id, x_af, self.axes), ldj

    def inverse(self, x, theta):
        x_id, x_af, s, t = self._conditioner(x, theta)
        z_af, ldj = C.rnvp_backward(s, t, x_af)
        return C.recombine_features(x_id, z_af, self.axes), ldj

    def forward_(self, z, theta):
        z_id, z_af, s, t = self._conditioner(z, theta)
        return C.recombine_features(z_id, z_af * jnp.exp(s) + t, self.axes)

    def summarize(self) -> str:
        return (
            f"JointRNVPCouplingLayer | st_net > {list(self.st_net.dims)} "
            f"({count_params(self.st_net)} parameters)\n"
            f"                       | axes   > {self.axes.summarize()}"
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NICECouplingLayer:
    """NICE additive (volume-preserving) coupling layer
    (reference src/affine/NICE.jl:31-38; trainable leaf: ``t_net``)."""

    t_net: MLP
    axes: CouplingAxes = dataclasses.field(metadata=dict(static=True))

    def _conditioner(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        return y_id, y_af, apply_mlp(self.t_net, C.nn_input(y_id, theta))

    def forward(self, z, theta):
        z_id, z_af, t = self._conditioner(z, theta)
        x_af, ldj = C.nice_forward(t, z_af)
        return C.recombine_features(z_id, x_af, self.axes), ldj

    def inverse(self, x, theta):
        x_id, x_af, t = self._conditioner(x, theta)
        z_af, ldj = C.nice_backward(t, x_af)
        return C.recombine_features(x_id, z_af, self.axes), ldj

    def forward_(self, z, theta):
        z_id, z_af, t = self._conditioner(z, theta)
        return C.recombine_features(z_id, z_af + t, self.axes)

    def summarize(self) -> str:
        return (
            f"NICECouplingLayer | t_net > {list(self.t_net.dims)} "
            f"({count_params(self.t_net)} parameters)\n"
            f"                  | axes  > {self.axes.summarize()}"
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RQSCouplingLayer:
    """Rational-quadratic spline coupling layer (Neural Spline Flows,
    Durkan et al. 2019 — capability addition beyond the reference's
    affine couplings; see ``ops/spline.py``).

    The conditioner MLP maps (θ ⊕ identity dims) to ``3K−1`` raw spline
    parameters per transformed dim; the elementwise monotone spline acts
    on ``[-bound, bound]`` with identity tails.
    """

    p_net: MLP
    axes: CouplingAxes = dataclasses.field(metadata=dict(static=True))
    n_bins: int = dataclasses.field(metadata=dict(static=True), default=8)
    bound: float = dataclasses.field(metadata=dict(static=True), default=3.0)

    def _params(self, y, theta):
        from ..ops.spline import n_spline_params

        y_id, y_af = C.split_features(y, self.axes)
        raw = apply_mlp(self.p_net, C.nn_input(y_id, theta))
        a = self.axes.transform_dim
        raw = raw.reshape(raw.shape[:-1] + (a, n_spline_params(self.n_bins)))
        return y_id, y_af, raw

    def forward(self, z, theta):
        from ..ops.spline import rq_spline

        z_id, z_af, raw = self._params(z, theta)
        x_af, ldj_e = rq_spline(z_af, raw, bound=self.bound, inverse=False)
        return (
            C.recombine_features(z_id, x_af, self.axes),
            jnp.sum(ldj_e, axis=-1),
        )

    def inverse(self, x, theta):
        from ..ops.spline import rq_spline

        x_id, x_af, raw = self._params(x, theta)
        z_af, ldj_e = rq_spline(x_af, raw, bound=self.bound, inverse=True)
        return (
            C.recombine_features(x_id, z_af, self.axes),
            jnp.sum(ldj_e, axis=-1),
        )

    def forward_(self, z, theta):
        """ldj-free spline sampling fast path: the derivative/log chain is
        skipped at the op level (``rq_spline(with_ldj=False)``), the spline
        analogue of the reference's ``forward!`` (src/Flows.jl:190-205)."""
        from ..ops.spline import rq_spline

        z_id, z_af, raw = self._params(z, theta)
        x_af, _ = rq_spline(z_af, raw, bound=self.bound, inverse=False,
                            with_ldj=False)
        return C.recombine_features(z_id, x_af, self.axes)

    def summarize(self) -> str:
        return (
            f"RQSCouplingLayer  | p_net > {list(self.p_net.dims)} "
            f"({count_params(self.p_net)} parameters, K={self.n_bins}, "
            f"bound={self.bound})\n"
            f"                  | axes  > {self.axes.summarize()}"
        )


def coupling_layer(
    d_or_axes_or_data,
    mask: Sequence[int] | int | None = None,
    *,
    kind: type = RNVPCouplingLayer,
    n: int = 0,
    reverse: bool = False,
    key=None,
    n_sublayers_s: int = 2,
    n_sublayers_t: int = 2,
    hidden_dim_s: int = 32,
    hidden_dim_t: int = 32,
    activation_s: str = "relu",
    activation_t: str = "relu",
    bias: bool = True,
    dtype=jnp.float32,
    n_bins: int = 8,
    bound: float = 3.0,
    zero_init_final: bool = True,
    max_log_scale: float = 0.0,
    joint_conditioner: bool = False,
):
    """Build a coupling layer with default conditioner MLPs.

    Collapses the reference ``CouplingLayer(...)`` overload family
    (src/Layers.jl:110-158) into one factory. The first argument is one of:

    - a :class:`CouplingAxes`,
    - an ``int`` dimension ``d`` (with ``mask`` = index list or split point,
      default ``d // 2``),
    - a :class:`~densityflows_tpu.data.DataArrays` (d and n inferred).

    Defaults match the reference: 2 sublayers, hidden 32, relu, bias on
    (src/Layers.jl:113-123). Conditioner input width =
    ``len(axis_nn)``, output width = ``len(axis_af)``
    (src/Layers.jl:126-127).

    Deliberate deviation: ``zero_init_final=True`` zero-initializes each
    conditioner's last dense layer, so every coupling layer is the
    identity at init. The reference's glorot-everywhere init makes deep
    or high-dimensional chains overflow through exp(s) at the first
    step (its 5-D examples never hit this); identity-at-init is the
    standard RealNVP/Glow stabilization. Pass ``False`` for the
    reference's exact init.

    ``joint_conditioner=True`` (RNVP only) builds a
    :class:`JointRNVPCouplingLayer`: ONE conditioner MLP emitting
    ``(s ‖ t)`` instead of two — half the matmuls per layer, the
    standard-RealNVP parameterization (the split default
    preserves the reference's separate s/t nets). Requires the s/t
    network hyperparameters to agree (one net serves both heads).

    ``max_log_scale`` (RNVP only, default 0 = off, reference semantics):
    when > 0, soft-clamps the log-scale to (−M, M) via ``M·tanh(s/M)``
    so out-of-distribution inputs yield very negative (finite) log-probs
    instead of the exp(s) overflow→NaN cascade. Near-identity within
    |s| ≲ M/2, so in-distribution densities are unchanged.
    """
    from ..data import DataArrays  # local import to avoid a cycle

    if isinstance(d_or_axes_or_data, CouplingAxes):
        axes = d_or_axes_or_data
    elif isinstance(d_or_axes_or_data, DataArrays):
        data = d_or_axes_or_data
        axes = coupling_axes(
            data.num_dimensions, mask, n=data.num_conditions, reverse=reverse
        )
    else:
        axes = coupling_axes(int(d_or_axes_or_data), mask, n=n, reverse=reverse)

    if key is None:
        key = jax.random.key(0)
    in_dim, out_dim = axes.nn_input_dim, axes.transform_dim
    k_s, k_t = jax.random.split(key)
    if joint_conditioner:
        if kind is not RNVPCouplingLayer:
            raise ValueError(
                "joint_conditioner=True is an RNVP parameterization "
                f"(got kind={kind.__name__})"
            )
        if (n_sublayers_s, hidden_dim_s, activation_s) != (
            n_sublayers_t, hidden_dim_t, activation_t
        ):
            raise ValueError(
                "joint_conditioner=True uses ONE net for both heads — "
                "the s/t hyperparameters must agree "
                f"(got s=({n_sublayers_s}, {hidden_dim_s}, {activation_s!r}) "
                f"vs t=({n_sublayers_t}, {hidden_dim_t}, {activation_t!r}))"
            )
        st_net = init_mlp(
            k_s, in_dim, 2 * out_dim, n_sublayers_s,
            hidden_dim=hidden_dim_s, activation=activation_s, bias=bias,
            dtype=dtype, zero_final=zero_init_final,
        )
        return JointRNVPCouplingLayer(st_net, axes, float(max_log_scale))
    if kind is RQSCouplingLayer:
        from ..ops.spline import n_spline_params

        p_net = init_mlp(
            k_t, in_dim, out_dim * n_spline_params(n_bins), n_sublayers_t,
            hidden_dim=hidden_dim_t, activation=activation_t, bias=bias,
            dtype=dtype, zero_final=zero_init_final,
        )
        return RQSCouplingLayer(p_net, axes, n_bins, float(bound))
    t_net = init_mlp(
        k_t, in_dim, out_dim, n_sublayers_t,
        hidden_dim=hidden_dim_t, activation=activation_t, bias=bias, dtype=dtype,
        zero_final=zero_init_final,
    )
    if kind is NICECouplingLayer:
        return NICECouplingLayer(t_net, axes)
    s_net = init_mlp(
        k_s, in_dim, out_dim, n_sublayers_s,
        hidden_dim=hidden_dim_s, activation=activation_s, bias=bias, dtype=dtype,
        zero_final=zero_init_final,
    )
    return RNVPCouplingLayer(s_net, t_net, axes, float(max_log_scale))
