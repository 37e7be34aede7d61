"""Conditioner MLPs (the s/t networks of coupling layers).

TPU-native counterpart of the reference's ``_dflt_net`` Flux MLP factory
(/root/reference/src/Layers.jl:29-47): ``Dense(in→hidden, σ)`` followed by
``n-1`` hidden ``Dense(hidden→hidden, σ)`` and a final linear
``Dense(hidden→out)``. Defaults match the reference: ``n_sublayers=2``,
``hidden_dim=32``, ``σ=relu``, ``bias=True``.

Design: parameters are a plain pytree (:class:`MLP` dataclass holding
weight/bias tuples); the apply function is pure and written so every layer
is one ``(batch, in) @ (in, out)`` matmul — the shape XLA tiles straight
onto the MXU. Weights are stored ``(in, out)`` (row-major activations),
the transpose of Flux's ``(out, in)`` convention.

Activations are referenced by *name* (static aux data) so layer pytrees
stay hashable and checkpointable; ``jnp`` compute uses fp32 accumulation
via ``preferred_element_type`` when activations are bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MLP", "init_mlp", "apply_mlp", "ACTIVATIONS", "count_params"]

ACTIVATIONS: dict[str, Callable] = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "gelu": jax.nn.gelu,
    "silu": jax.nn.silu,
    "sigmoid": jax.nn.sigmoid,
    "leaky_relu": jax.nn.leaky_relu,
    "softplus": jax.nn.softplus,
    "elu": jax.nn.elu,
    "identity": lambda x: x,
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MLP:
    """Stack of dense layers. ``weights[i]``: (in_i, out_i); ``biases[i]``:
    (out_i,) or scalar 0-width placeholder when bias is disabled."""

    weights: tuple
    biases: tuple
    activation: str = dataclasses.field(metadata=dict(static=True), default="relu")

    @property
    def dims(self) -> tuple[int, ...]:
        """Layer widths [in, h1, ..., out] (reference summarize, RNVP.jl:59-69)."""
        return tuple(int(w.shape[0]) for w in self.weights) + (
            int(self.weights[-1].shape[1]),
        )


def _glorot_uniform(key, shape, dtype):
    # Flux's default Dense init (glorot_uniform) — keeps learned nets
    # statistically comparable with the reference at init time.
    fan_in, fan_out = shape
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, minval=-limit, maxval=limit)


def init_mlp(
    key,
    input_dim: int,
    output_dim: int,
    n_sublayers: int = 2,
    *,
    hidden_dim: int = 32,
    activation: str = "relu",
    bias: bool = True,
    dtype=jnp.float32,
    zero_final: bool = False,
) -> MLP:
    """Build an MLP matching the reference ``_dflt_net`` architecture
    (src/Layers.jl:29-47): in→hidden(σ), (n_sublayers-1)×hidden→hidden(σ),
    hidden→out (linear).

    ``zero_final=True`` zero-initializes the last dense layer so a
    coupling conditioner outputs s=t=0 at init — the flow starts as the
    identity. This is the stability fix for deep/high-d chains where
    glorot-initialized s-nets cascade through exp(s) to overflow (the
    reference's tiny 5-D configs never hit this; its mitigation is the
    trailing NormalizationLayer, docs/src/documentation.md:61).
    """
    if n_sublayers < 1:
        raise ValueError("n_sublayers must be >= 1")
    dims = [input_dim] + [hidden_dim] * n_sublayers + [output_dim]
    keys = jax.random.split(key, len(dims) - 1)
    weights, biases = [], []
    n_layers = len(dims) - 1
    for i, (k, d_in, d_out) in enumerate(zip(keys, dims[:-1], dims[1:])):
        if zero_final and i == n_layers - 1:
            weights.append(jnp.zeros((d_in, d_out), dtype))
        else:
            weights.append(_glorot_uniform(k, (d_in, d_out), dtype))
        biases.append(jnp.zeros((d_out,), dtype) if bias else jnp.zeros((0,), dtype))
    return MLP(tuple(weights), tuple(biases), activation)


def apply_mlp(mlp: MLP, x: jax.Array) -> jax.Array:
    """Apply the MLP along the last axis of ``x``: (batch..., in) → (batch..., out).

    Compute runs in the WEIGHTS' dtype end-to-end (bf16 weights →
    bf16 tensor-core passes with f32 accumulation; bias/activation in
    bf16; one cast back to ``x.dtype`` at the end). Keeping the
    inter-layer activations in the weights' dtype is what makes the
    BACKWARD matmuls bf16 too — an f32 epilogue per layer makes every
    cotangent f32, silently promoting dL/dW and dL/dx (~2/3 of training
    FLOPs) to f32 matmuls.
    """
    act = ACTIVATIONS[mlp.activation]
    n = len(mlp.weights)
    h = x
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        h = jnp.dot(h.astype(w.dtype), w)
        if b.shape[0]:
            h = h + b
        if i < n - 1:  # final layer is linear (reference src/Layers.jl:41)
            h = act(h)
    return h.astype(x.dtype) if h.dtype != x.dtype else h


def count_params(mlp: MLP) -> int:
    return sum(int(np.prod(w.shape)) for w in mlp.weights) + sum(
        int(b.shape[0]) for b in mlp.biases
    )
