"""Flow chains: ordered composition of flow elements with ldj accumulation.

JAX counterpart of the reference ``FlowChain``
(/root/reference/src/Chains.jl:78-197). Semantics preserved:

- ``forward`` folds first→last (latent → data), ``inverse`` folds
  last→first (data → latent), ldj accumulated additively
  (Chains.jl:149-184; SURVEY.md §2.4.6);
- ``forward_`` is the ldj-free sampling sweep (the ``forward!`` fold,
  Chains.jl:187-197);
- ``concatenate`` merges chains and elements (Chains.jl:112-123);
- Python sequence protocol replaces the forwarded Base iteration
  (Chains.jl:125-138).

The layer tuple is a pytree of heterogeneous elements; the fold is a
Python loop unrolled at trace time (chains are shallow, 3–16 elements),
which lets XLA fuse the whole chain into one program — including the
sampling path where the entire composed transform becomes a single
donated-buffer kernel.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["FlowChain", "flow_chain", "concatenate"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlowChain:
    """Tuple of flow elements (reference src/Chains.jl:78-80)."""

    layers: tuple

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return FlowChain(self.layers[i])
        return self.layers[i]

    def __iter__(self):
        return iter(self.layers)

    def forward(self, z, theta):
        """latent → data fold, first→last (reference Chains.jl:168-184)."""
        ldj = None
        for layer in self.layers:
            z, ldj_i = layer.forward(z, theta)
            ldj = ldj_i if ldj is None else ldj + ldj_i
        return z, ldj

    def inverse(self, x, theta):
        """data → latent fold, last→first (reference ``backward``,
        Chains.jl:149-165)."""
        ldj = None
        for layer in reversed(self.layers):
            x, ldj_i = layer.inverse(x, theta)
            ldj = ldj_i if ldj is None else ldj + ldj_i
        return x, ldj

    def forward_(self, z, theta):
        """ldj-free sampling sweep (reference ``forward!`` fold,
        Chains.jl:187-197). Where the router picks it, the whole chain
        runs as ONE fused GPU kernel (models/fused_chain.py)."""
        from .fused_chain import maybe_apply_fused

        out = maybe_apply_fused(self, z, theta, "fwd", False)
        if out is not None:
            return out
        for layer in self.layers:
            z = layer.forward_(z, theta)
        return z

    def summarize(self) -> str:
        return "\n".join(layer.summarize() for layer in self.layers)


def flow_chain(*elements) -> FlowChain:
    """Build a chain from elements, or replicate a factory:
    ``flow_chain(factory, n, *args, key=..., **kwargs)`` builds ``n``
    independently-initialized elements (reference
    ``FlowChain(T, n, args...)``, Chains.jl:99-101)."""
    if elements and callable(elements[0]) and not hasattr(elements[0], "forward"):
        factory, n, *args = elements

        def build(**kwargs):
            key = kwargs.pop("key", jax.random.key(0))
            keys = jax.random.split(key, n)
            return FlowChain(
                tuple(factory(*args, key=k, **kwargs) for k in keys)
            )

        return build
    if len(elements) == 1 and isinstance(elements[0], (tuple, list)):
        elements = tuple(elements[0])
    return FlowChain(tuple(elements))


def concatenate(*parts) -> FlowChain:
    """Merge chains and elements into one chain (reference
    Chains.jl:112-123)."""
    layers = []
    for p in parts:
        if isinstance(p, FlowChain):
            layers.extend(p.layers)
        elif isinstance(p, (tuple, list)):
            for q in p:
                layers.extend(q.layers if isinstance(q, FlowChain) else [q])
        else:
            layers.append(p)
    return FlowChain(tuple(layers))
