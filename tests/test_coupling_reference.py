"""Coupling layers against a float64 NumPy reference written here.

``tests/test_coupling.py`` checks round trips, autodiff Jacobians and the
clamp; this file adds an independent value reference — the reference
RNVP/NICE formulas (src/affine/RNVP.jl:77-96, 168-187; NICE.jl:63-81)
over the ``axis_nn`` conditioner input (src/Axes.jl:90-98) in float64 —
and checks ``jax.grad`` against central differences of that reference
for every conditioner activation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import densityflows_tpu as df
from densityflows_tpu.ops.mlp import ACTIVATIONS

D, N = 5, 2
MASK = [0, 2, 3]


def _np_act(name, u):
    if name == "relu":
        return np.maximum(u, 0.0)
    if name == "tanh":
        return np.tanh(u)
    if name == "gelu":  # jax.nn.gelu's default tanh approximation
        c = np.sqrt(2.0 / np.pi)
        return 0.5 * u * (1.0 + np.tanh(c * (u + 0.044715 * u ** 3)))
    if name == "silu":
        return u / (1.0 + np.exp(-u))
    if name == "sigmoid":
        return 1.0 / (1.0 + np.exp(-u))
    if name == "leaky_relu":
        return np.where(u >= 0, u, 0.01 * u)
    if name == "softplus":
        return np.logaddexp(0.0, u)
    if name == "elu":
        return np.where(u > 0, u, np.expm1(np.minimum(u, 0.0)))
    if name == "identity":
        return u
    raise KeyError(name)


def _np_mlp(net, h):
    ws = [np.asarray(w, np.float64) for w in net.weights]
    bs = [np.asarray(b, np.float64) for b in net.biases]
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ w + (b if b.size else 0.0)
        if i < len(ws) - 1:
            h = _np_act(net.activation, h)
    return h


def _np_layer(layer, y, th, direction):
    """(y', ldj) of one coupling layer in float64."""
    ax = layer.axes
    y = np.asarray(y, np.float64)
    h = np.concatenate([np.asarray(th, np.float64), y[:, list(ax.axis_id)]],
                       axis=-1)
    t = _np_mlp(layer.t_net, h)
    s = (_np_mlp(layer.s_net, h) if isinstance(layer, df.RNVPCouplingLayer)
         else np.zeros_like(t))
    y_af = y[:, list(ax.axis_af)]
    if direction == "forward":
        out, ldj = y_af * np.exp(s) + t, s.sum(-1)
    else:
        out, ldj = (y_af - t) * np.exp(-s), -s.sum(-1)
    res = y.copy()
    res[:, list(ax.axis_af)] = out
    return res, ldj


def _layer(kind, activation="tanh", key=0):
    return df.coupling_layer(
        D, MASK, n=N, kind=kind, key=jax.random.key(key),
        hidden_dim_s=12, hidden_dim_t=12, activation_s=activation,
        activation_t=activation, zero_init_final=False)


def _inputs(rows=24, key=1):
    rng = np.random.default_rng(key)
    return (rng.normal(size=(rows, D)).astype(np.float32),
            rng.uniform(size=(rows, N)).astype(np.float32))


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("kind", [df.RNVPCouplingLayer,
                                  df.NICECouplingLayer])
def test_layer_matches_float64_reference(kind, direction):
    layer = _layer(kind)
    y, th = _inputs()
    with jax.default_matmul_precision("highest"):
        got, ldj = getattr(layer, direction)(jnp.asarray(y), jnp.asarray(th))
    want, want_ldj = _np_layer(layer, y, th, direction)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ldj), want_ldj, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_grad_matches_central_differences(activation):
    """d/dy of Σ(z²)/2 − Σ ldj through the inverse (the NLL's shape),
    from ``jax.grad`` in float32 vs central differences of the float64
    reference."""
    layer = _layer(df.RNVPCouplingLayer, activation, key=3)
    y, th = _inputs(rows=6, key=4)

    def loss_jax(yy):
        z, ldj = layer.inverse(yy, jnp.asarray(th))
        return 0.5 * jnp.sum(z * z) - jnp.sum(ldj)

    def loss_np(yy):
        z, ldj = _np_layer(layer, yy, th, "inverse")
        return 0.5 * np.sum(z * z) - np.sum(ldj)

    with jax.default_matmul_precision("highest"):
        g = np.asarray(jax.grad(loss_jax)(jnp.asarray(y)))
    eps = 1e-5
    y64 = y.astype(np.float64)
    num = np.zeros_like(y64)
    for idx in np.ndindex(*y64.shape):
        e = np.zeros_like(y64)
        e[idx] = eps
        num[idx] = (loss_np(y64 + e) - loss_np(y64 - e)) / (2 * eps)
    np.testing.assert_allclose(g, num, rtol=2e-3, atol=2e-3)
