"""Affine-coupling transform kernels (pure jnp reference path).

JAX counterpart of the reference transform layer
(/root/reference/src/affine/RNVP.jl, /root/reference/src/affine/NICE.jl).
Math parity (SURVEY.md §2.4.5):

- forward  (latent z → data x):  x_af = z_af · exp(s) + t,  ldj = +Σ s
- backward (data x → latent z):  z_af = (x_af − t) · exp(−s), ldj = −Σ s
- NICE is the s ≡ 0 volume-preserving special case.
- s, t are conditioner MLPs of ``concat([θ, identity dims])``
  (the ``axis_nn`` rule, src/Axes.jl:90-98; src/affine/RNVP.jl:150-165).
- ldj is per-sample with the batch shape (src/affine/RNVP.jl:86).

Where the reference needs hand-written ChainRules ``rrule``s because Zygote
cannot differentiate its ``selectdim`` scatter writes
(src/affine/RNVP.jl:99-147, src/affine/NICE.jl:84-115), this path needs
none: the split/recombine is expressed as static gathers that ``jax.grad``
differentiates exactly, and XLA fuses the exp/mul/add chain into the
conditioner matmuls. This module is the one training path and the
correctness reference for the whole-chain fold kernel
(``ops/pallas_chain.py``).

All index sets are trace-time constants (tuples from
:class:`~densityflows_tpu.axes.CouplingAxes`), so each layer's
gather/recombine pattern compiles to fixed slices — no dynamic shapes, no
scatter in the autodiff path.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..axes import CouplingAxes

__all__ = [
    "split_features",
    "recombine_features",
    "nn_input",
    "rnvp_forward",
    "rnvp_backward",
    "nice_forward",
    "nice_backward",
]


def split_features(x, axes: CouplingAxes):
    """Split (batch..., d) into identity and transformed parts along the
    last axis using the static index sets."""
    x_id = x[..., list(axes.axis_id)] if axes.axis_id else x[..., :0]
    x_af = x[..., list(axes.axis_af)] if axes.axis_af else x[..., :0]
    return x_id, x_af


def _inverse_perm(axes: CouplingAxes) -> list[int]:
    perm = list(axes.axis_id) + list(axes.axis_af)
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    return inv.tolist()


def recombine_features(y_id, y_af, axes: CouplingAxes):
    """Undo :func:`split_features`: place identity/transformed parts back at
    their original feature positions with one static gather (cheaper than two
    scatters; replaces the reference's in-place ``selectdim`` writes)."""
    stacked = jnp.concatenate([y_id, y_af], axis=-1)
    return stacked[..., _inverse_perm(axes)]


def nn_input(x_id, theta):
    """Conditioner input: θ first, then the identity dims — the ``axis_nn``
    ordering of ``concat([θ, x])[axis_nn]`` (src/Axes.jl:90-98) without
    materializing the full concat."""
    return jnp.concatenate([theta, x_id], axis=-1)


# -- RealNVP ---------------------------------------------------------------

def rnvp_forward(s, t, z_af):
    """x_af = z_af·exp(s) + t, ldj = +Σs (reference src/affine/RNVP.jl:168-187).

    s is summed in fp32 so bf16 activations cannot corrupt the log-det.
    """
    x_af = z_af * jnp.exp(s) + t
    ldj = jnp.sum(s.astype(jnp.float32), axis=-1)
    return x_af, ldj


def rnvp_backward(s, t, x_af):
    """z_af = (x_af − t)·exp(−s), ldj = −Σs (reference src/affine/RNVP.jl:77-96)."""
    z_af = (x_af - t) * jnp.exp(-s)
    ldj = -jnp.sum(s.astype(jnp.float32), axis=-1)
    return z_af, ldj


# -- NICE (volume-preserving, s ≡ 0) ---------------------------------------

def nice_forward(t, z_af):
    """x_af = z_af + t, ldj = 0 (reference src/affine/NICE.jl:135-153)."""
    x_af = z_af + t
    ldj = jnp.zeros(x_af.shape[:-1], dtype=jnp.float32)
    return x_af, ldj


def nice_backward(t, x_af):
    """z_af = x_af − t, ldj = 0 (reference src/affine/NICE.jl:63-81)."""
    z_af = x_af - t
    ldj = jnp.zeros(z_af.shape[:-1], dtype=jnp.float32)
    return z_af, ldj
