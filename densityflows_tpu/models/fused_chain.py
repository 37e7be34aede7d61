"""Whole-chain fusion: compile a FlowChain into one GPU kernel pass.

Builds the static op *plan* + flat, padded parameter list that
``ops/pallas_chain.py`` executes, and wraps the kernel in a
``jax.custom_vjp`` whose backward runs the pure-jnp per-layer fold — so
the fused chain is safe under ``jax.grad`` while it targets the inference
hot paths: the sampling sweep (the reference's ``forward!`` fold,
DensityFlows.jl src/Chains.jl:187-197) and density evaluation
(src/Flows.jl:272-281).

Supported elements: RNVP/NICE/joint couplings, Normalization, ActNorm,
Permutation, InvertibleLinear (LU), Logit. Chains containing anything
else (splines, MAF/IAF, embeddings) keep the per-layer path.

Routing (:func:`use_fused_chain`) is a pure function of what the caller
can observe — platform, rows, width, hidden width, conditioner form —
and never of whether a call fails: a kernel error propagates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coupling as C
from ..ops.pallas_chain import op_param_count, pow2_width, run_chain
from .glow import ActNormLayer, InvertibleLinearLayer
from .layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
)
from .normalization import LogitLayer, NormalizationLayer, PermutationLayer

__all__ = ["maybe_apply_fused", "apply_fused", "chain_is_fusable",
           "use_fused_chain", "routes_to_kernel"]

_COUPLINGS = (RNVPCouplingLayer, NICECouplingLayer, JointRNVPCouplingLayer)

# Router box: the shapes where the kernel beat XLA's fold on the H100
# (PERF.md, "Kernel decisions"; 2^18 rows, split conditioners): it won
# 1.3-2x at hidden <= 64 for d in 8..32, tied at hidden 128 and lost
# ~2x at hidden >= 256, split or joint. Joint chains at narrow widths
# were not measured, so they keep XLA's fold.
_CHAIN_MIN_ROWS = 1 << 18
_CHAIN_MIN_D, _CHAIN_MAX_D = 8, 32
_CHAIN_MAX_HIDDEN = 64


def use_fused_chain(platform: str, rows: int, d: int, hidden: int,
                    joint: bool) -> bool:
    """Whether the fold runs as the fused kernel: only compiled for the
    GPU, and only at the shapes where it measured faster than XLA."""
    return (platform == "gpu"
            and not joint
            and rows >= _CHAIN_MIN_ROWS
            and _CHAIN_MIN_D <= d <= _CHAIN_MAX_D
            and hidden <= _CHAIN_MAX_HIDDEN)


def _pad(w, rows, cols, fill=0.0):
    w = jnp.asarray(w, jnp.float32)
    if w.ndim == 1:
        w = w.reshape(1, -1)
    return jnp.pad(w, ((0, rows - w.shape[0]), (0, cols - w.shape[1])),
                   constant_values=fill)


def _scatter_cols(w, cols, idx):
    """(r, |idx|) → (r, cols) with the columns placed at ``idx``."""
    w = jnp.asarray(w, jnp.float32)
    if w.ndim == 1:
        w = w.reshape(1, -1)
    return jnp.zeros((w.shape[0], cols), jnp.float32).at[:, idx].set(w)


class _Shapes:
    """Padded kernel widths: features D, conditions N, hidden H."""

    def __init__(self, d, n, hidden):
        self.d, self.n = d, n
        self.D, self.N, self.H = pow2_width(d), pow2_width(n), hidden


def _fold_first(w0, ax, sh, params):
    """First dense layer (K, h), K = n + |id|, split into a θ part (N, H)
    and an x part scattered to the identity rows of (D, H) — so
    ``θ@W1θ + x@W1x`` reproduces ``h = [θ | x[:, id]]`` (axis_nn
    ordering, src/Axes.jl:90-98) with no gather in the kernel."""
    n = ax.n
    w0 = jnp.asarray(w0, jnp.float32)
    if n:
        params.append(_pad(w0[:n], sh.N, sh.H))
    if len(ax.axis_id):
        w1x = jnp.zeros((sh.D, sh.H), jnp.float32)
        params.append(w1x.at[np.asarray(ax.axis_id), :w0.shape[1]].set(
            w0[n:]))


def _coupling_entry(layer, dirn, sh):
    ax = layer.axes
    af = np.asarray(ax.axis_af)
    params = []

    def biased(net):
        return bool(net.biases[0].shape[0])

    if isinstance(layer, JointRNVPCouplingLayer):
        net, a = layer.st_net, ax.transform_dim
        ws = net.weights
        _fold_first(ws[0], ax, sh, params)
        params.extend(_pad(w, sh.H, sh.H) for w in ws[1:-1])
        for head in (ws[-1][:, :a], ws[-1][:, a:]):
            params.append(_pad(_scatter_cols(head, sh.D, af), sh.H, sh.D))
        if biased(net):
            params.extend(_pad(b, 1, sh.H) for b in net.biases[:-1])
            bf = net.biases[-1]
            params.extend(_scatter_cols(h, sh.D, af) for h in (bf[:a], bf[a:]))
        op = ("coupling", "joint", dirn, len(ws), 0, net.activation,
              net.activation, biased(net), False, ax.n > 0,
              len(ax.axis_id) > 0, float(layer.max_log_scale))
        return op, params

    def fold_net(net):
        ws = net.weights
        _fold_first(ws[0], ax, sh, params)
        params.extend(_pad(w, sh.H, sh.H) for w in ws[1:-1])
        params.append(_pad(_scatter_cols(ws[-1], sh.D, af), sh.H, sh.D))
        if biased(net):
            params.extend(_pad(b, 1, sh.H) for b in net.biases[:-1])
            params.append(_scatter_cols(net.biases[-1], sh.D, af))
        return len(ws), net.activation, biased(net)

    if isinstance(layer, RNVPCouplingLayer):
        kind = "nvp"
        n_s, act_s, bias_s = fold_net(layer.s_net)
        clamp = float(layer.max_log_scale)
    else:
        kind, n_s, act_s, bias_s, clamp = "nice", 0, "identity", False, 0.0
    n_t, act_t, bias_t = fold_net(layer.t_net)
    op = ("coupling", kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t,
          ax.n > 0, len(ax.axis_id) > 0, clamp)
    return op, params


def _affine(a, b, c, sh):
    return ("affine",), [_pad(a, 1, sh.D, 1.0), _pad(b, 1, sh.D)], c


def _normalization_entry(layer, dirn, sh):
    lo = jax.lax.stop_gradient(layer.x_min).astype(jnp.float32)
    hi = jax.lax.stop_gradient(layer.x_max).astype(jnp.float32)
    diff = hi - lo
    delta = layer.beta - layer.alpha
    c = jnp.sum(jnp.log(diff / delta))
    if dirn == "fwd":  # [α,β] → [lo,hi] (reference Normalization.jl:79-92)
        return _affine(diff / delta,
                       (layer.beta * lo - layer.alpha * hi) / delta, c, sh)
    # [lo,hi] → [α,β] (Normalization.jl:64-77)
    return _affine(delta / diff,
                   (layer.alpha * hi - layer.beta * lo) / diff, -c, sh)


def _actnorm_entry(layer, dirn, sh):
    ls = layer.log_scale.astype(jnp.float32)
    bias = layer.bias.astype(jnp.float32)
    c = jnp.sum(ls)
    if dirn == "fwd":  # x = z·e⁻ˢ + b
        return _affine(jnp.exp(-ls), bias, -c, sh)
    a = jnp.exp(ls)  # z = (x − b)·eˢ
    return _affine(a, -bias * a, c, sh)


def _invlinear_entry(layer, dirn, sh):
    from jax.scipy.linalg import solve_triangular

    c = jnp.sum(layer.log_s.astype(jnp.float32))
    if dirn == "inv":  # z = x @ Wᵀ
        return ("linear",), [_pad(layer._w().T, sh.D, sh.D)], c
    # forward: x = z @ W⁻ᵀ; W⁻¹ = U⁻¹ L⁻¹ Π with Π y = y[inv_perm]
    lower, upper = layer._lu()
    e = jnp.eye(layer.d, dtype=jnp.float32)[list(layer._inv_perm()), :]
    w_inv = solve_triangular(
        upper.astype(jnp.float32),
        solve_triangular(lower.astype(jnp.float32), e, lower=True,
                         unit_diagonal=True),
        lower=False,
    )
    return ("linear",), [_pad(w_inv.T, sh.D, sh.D)], -c


def _permutation_entry(layer, dirn, sh):
    perm = np.asarray(layer.perm)
    if dirn == "inv":
        perm = np.argsort(perm)
    # m[perm[j], j] = 1 so that (x @ m)[:, j] = x[:, perm[j]]
    m = np.zeros((sh.D, sh.D), np.float32)
    m[perm, np.arange(len(perm))] = 1.0
    return ("linear",), [jnp.asarray(m)], jnp.float32(0.0)


def _logit_entry(layer, dirn, sh):
    lo = layer.lo.astype(jnp.float32).reshape(1, -1)
    hi = layer.hi.astype(jnp.float32).reshape(1, -1)
    return (("logit", dirn, float(layer.eps)),
            [lo, hi, jnp.log(hi - lo)], jnp.float32(0.0))


def _iter_layers(chain, dirn):
    # blocks may nest one level (CouplingBlock holds layer_1/layer_2)
    from .blocks import CouplingBlock

    seq = chain.layers if dirn == "fwd" else tuple(reversed(chain.layers))
    for layer in seq:
        if isinstance(layer, CouplingBlock):
            pair = (layer.layer_1, layer.layer_2)
            yield from pair if dirn == "fwd" else reversed(pair)
        else:
            yield layer


_ENTRIES = (
    (NormalizationLayer, _normalization_entry),
    (ActNormLayer, _actnorm_entry),
    (InvertibleLinearLayer, _invlinear_entry),
    (PermutationLayer, _permutation_entry),
    (LogitLayer, _logit_entry),
)


def _plan_params(chain, dirn, sh):
    """Static plan, flat padded params, and the summed constant ldj.
    Consecutive couplings with one signature (op and parameter shapes)
    become one ``"couplings"`` run with stacked parameters."""
    entries, const = [], jnp.float32(0.0)
    for layer in _iter_layers(chain, dirn):
        if isinstance(layer, _COUPLINGS):
            op, p = _coupling_entry(layer, dirn, sh)
            sig = (op, tuple(w.shape for w in p))
            if entries and entries[-1][0] == sig:
                entries[-1][1].append(p)
            else:
                entries.append((sig, [p]))
        else:
            entry = next(f for t, f in _ENTRIES if isinstance(layer, t))
            op, p, c = entry(layer, dirn, sh)
            const = const + c
            entries.append(((op, None), p))
    plan, params = [], []
    for (op, shapes), p in entries:
        if shapes is not None:  # a run of couplings
            op = ("couplings", len(p), op)
            p = [jnp.stack(ws) for ws in zip(*p)]
        assert len(p) == op_param_count(op)
        plan.append(op)
        params.extend(p)
    return tuple(plan), params, const


def _conditioner_nets(layer):
    if isinstance(layer, RNVPCouplingLayer):
        return (layer.s_net, layer.t_net)
    if isinstance(layer, NICECouplingLayer):
        return (layer.t_net,)
    if isinstance(layer, JointRNVPCouplingLayer):
        return (layer.st_net,)
    return ()


def _max_hidden(chain) -> int:
    """Widest conditioner hidden layer — what the router thresholds on."""
    return max((int(np.shape(w)[-1]) for layer in _iter_layers(chain, "fwd")
                for net in _conditioner_nets(layer)
                for w in net.weights[:-1]), default=0)


def _has_joint(chain) -> bool:
    return any(isinstance(layer, JointRNVPCouplingLayer)
               for layer in _iter_layers(chain, "fwd"))


def chain_is_fusable(chain, d: int) -> bool:
    """Static feasibility: every element has a kernel op and every
    conditioner has a hidden layer."""
    layers = list(_iter_layers(chain, "fwd"))
    if not layers:
        return False
    for layer in layers:
        if isinstance(layer, _COUPLINGS):
            ax = layer.axes
            if ax.transform_dim == 0 or ax.nn_input_dim == 0:
                return False
            if any(len(net.weights) < 2 for net in _conditioner_nets(layer)):
                return False
        elif isinstance(layer, LogitLayer):
            # padded columns would add logit ldj terms
            if pow2_width(d) != d:
                return False
        elif not any(isinstance(layer, t) for t, _ in _ENTRIES):
            return False
    return True


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _chain_fused(chain, x2, th2, dirn, with_ldj, interpret):
    rows, d = x2.shape
    n = th2.shape[-1]
    sh = _Shapes(d, n, pow2_width(_max_hidden(chain)))
    plan, params, const = _plan_params(chain, dirn, sh)
    x = jnp.pad(x2, ((0, 0), (0, sh.D - d))) if sh.D != d else x2
    th = jnp.pad(th2, ((0, 0), (0, sh.N - n))) if n else None
    out = run_chain(plan, params, x, th, with_ldj=with_ldj, hidden=sh.H,
                    interpret=interpret)
    if with_ldj:
        y, ldj = out
        return y[:, :d], ldj + const
    return out[:, :d]


def _layer_jnp(layer, y, theta, dirn):
    """Per-layer pure-jnp apply (the correctness oracle)."""
    if isinstance(layer, RNVPCouplingLayer):
        y_id, y_af, s, t = layer._conditioner(y, theta)
        out, ldj = (C.rnvp_forward(s, t, y_af) if dirn == "fwd"
                    else C.rnvp_backward(s, t, y_af))
        return C.recombine_features(y_id, out, layer.axes), ldj
    if isinstance(layer, NICECouplingLayer):
        y_id, y_af, t = layer._conditioner(y, theta)
        out, ldj = (C.nice_forward(t, y_af) if dirn == "fwd"
                    else C.nice_backward(t, y_af))
        return C.recombine_features(y_id, out, layer.axes), ldj
    return layer.forward(y, theta) if dirn == "fwd" else layer.inverse(y, theta)


def _jnp_chain(chain, x2, th2, dirn, with_ldj):
    y, ldj = x2, None
    for layer in _iter_layers(chain, dirn):
        y, ldj_i = _layer_jnp(layer, y, th2, dirn)
        ldj = ldj_i if ldj is None else ldj + ldj_i
    return (y, ldj) if with_ldj else y


def _chain_fused_fwd(chain, x2, th2, dirn, with_ldj, interpret):
    out = _chain_fused(chain, x2, th2, dirn, with_ldj, interpret)
    return out, (chain, x2, th2)


def _chain_fused_bwd(dirn, with_ldj, interpret, res, g):
    del interpret
    chain, x2, th2 = res
    _, vjp = jax.vjp(
        lambda c, xx, tt: _jnp_chain(c, xx, tt, dirn, with_ldj),
        chain, x2, th2,
    )
    return vjp(g)


_chain_fused.defvjp(_chain_fused_fwd, _chain_fused_bwd)


def apply_fused(chain, y, theta, dirn, with_ldj, *, interpret=False):
    """Fold ``y`` (batch..., d) through the whole chain as one kernel;
    ``dirn``: "fwd" | "inv". The chain must be :func:`chain_is_fusable`.
    ``interpret=True`` runs the Pallas interpreter (CPU tests)."""
    batch_shape = y.shape[:-1]
    rows = int(np.prod(batch_shape))
    d = y.shape[-1]
    n = theta.shape[-1] if theta is not None else 0
    x2 = y.reshape(rows, d)
    th2 = (theta.reshape(rows, n) if theta is not None
           else jnp.zeros((rows, 0), y.dtype))
    out = _chain_fused(chain, x2, th2, dirn, with_ldj, interpret)
    if with_ldj:
        yy, ldj = out
        return yy.reshape(y.shape), ldj.reshape(batch_shape)
    return out.reshape(y.shape)


def routes_to_kernel(chain, rows: int, d: int) -> bool:
    """Whether a fold of ``rows`` rows through ``chain`` runs as the
    kernel on the current backend."""
    return (use_fused_chain(jax.default_backend(), rows, d,
                            _max_hidden(chain), _has_joint(chain))
            and chain_is_fusable(chain, d))


def maybe_apply_fused(chain, y, theta, dirn, with_ldj):
    """The fused fold where the router picks it, else ``None`` (the
    caller keeps the per-layer path)."""
    if y.ndim < 2:
        return None
    if not routes_to_kernel(chain, int(np.prod(y.shape[:-1])), y.shape[-1]):
        return None
    return apply_fused(chain, y, theta, dirn, with_ldj)
