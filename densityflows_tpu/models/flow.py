"""The Flow engine: model + base distribution + θ-metadata + histories.

JAX counterpart of the reference ``Flow`` wrapper and its
density/sampling API (/root/reference/src/Flows.jl). Semantic parity:

- θ is min-max normalized to [0,1] **exactly once, at the Flow boundary**,
  using metadata captured from the data (the ``@flow_wrapper`` semantics,
  src/Macros.jl:104-112; SURVEY.md §2.4.3);
- every API has an unconditional form — ``theta=None`` plays the role of
  the zero-width ``dflt_θ`` sentinel (src/Macros.jl:126-128);
- ``sample`` = base draw → ldj-free forward sweep (the reference's
  in-place ``forward!`` path, src/Flows.jl:157-172) — here a single jitted
  donated-buffer program;
- ``log_prob`` = base.log_prob(inverse(x)) + ldj (src/Flows.jl:272-281),
  with the grid variant over per-axis vectors (src/Flows.jl:287-331);
- loss = −mean(base.log_prob(z) + ldj) (src/Flows.jl:352-359);
- train/valid loss histories live on the Flow (src/Flows.jl:44-45).

The Flow object itself is a thin mutable host-side handle (histories
append during training; the model is swapped after each epoch); all device
compute goes through module-level jitted pure functions so jit caches are
shared across Flow instances with the same architecture.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data import DataArrays, MetaData, normalize_input
from .chains import FlowChain
from .distributions import StandardNormal

__all__ = ["Flow", "nll_loss"]


def nll_loss(model, base, x, theta):
    """Forward-KL NLL: −mean(base.log_prob(z) + ldj) over the batch
    (reference ``loss``, src/Flows.jl:352-359)."""
    z, ldj = model.inverse(x, theta)
    return -jnp.mean(base.log_prob(z) + ldj)


@partial(jax.jit, donate_argnums=(2,))
def _sample_program(model, base_stub, r, theta):
    """Donated-buffer sampling sweep: the jitted analogue of the reference's
    in-place ``forward!`` chain fold (src/Flows.jl:157-172,
    src/Chains.jl:187-197). ``r`` (the base draw) is donated so XLA reuses
    its buffer through the whole chain."""
    del base_stub
    return model.forward_(r, theta)


# row-chunked fold: a memory bound, not a speed route. On the H100 the
# straight fold over 2^18 rows beat 4096-row chunks by 1.4-7x at every
# width measured (PERF.md, "Kernel decisions"), so the fold is chunked
# only when one layer's activations would pass 1 GiB, in blocks of the
# row count measured fast.
_FOLD_CHUNK = 1 << 18
_FOLD_CHUNK_BYTES = 1 << 30


def _max_conditioner_width(model) -> int:
    from ..ops.mlp import MLP

    nodes = jax.tree_util.tree_flatten(
        model, is_leaf=lambda n: isinstance(n, MLP))[0]
    return max((int(w.shape[-1]) for n in nodes if isinstance(n, MLP)
                for w in n.weights), default=0)


@partial(jax.jit, donate_argnums=(1,))
def _sample_program_chunked(model, r, theta):
    """The same fold in ``_FOLD_CHUNK``-row blocks (lax.scan +
    dynamic_slice) so the live activations stay bounded."""
    rows, d = r.shape[0], r.shape[-1]
    c = _FOLD_CHUNK
    pad = (-rows) % c
    if pad:
        r = jnp.concatenate(
            [r, jnp.zeros((pad,) + r.shape[1:], r.dtype)])
        theta = jnp.concatenate(
            [theta, jnp.zeros((pad,) + theta.shape[1:], theta.dtype)])

    def body(carry, i):
        rc = jax.lax.dynamic_slice_in_dim(r, i * c, c)
        tc = jax.lax.dynamic_slice_in_dim(theta, i * c, c)
        return carry, model.forward_(rc, tc)

    _, outs = jax.lax.scan(body, 0,
                           jnp.arange((rows + pad) // c, dtype=jnp.int32))
    return outs.reshape(-1, d)[:rows]


def _chain_eval(model, y, theta, dirn):
    """Inverse/forward fold with ldj, routed through the whole-chain fused
    kernel where the router picks it (models/fused_chain.py; grad-safe —
    its custom-vjp backward runs the jnp fold)."""
    if isinstance(model, FlowChain):
        from .fused_chain import maybe_apply_fused

        res = maybe_apply_fused(model, y, theta, dirn, True)
        if res is not None:
            return res
    return model.forward(y, theta) if dirn == "fwd" else model.inverse(y, theta)


@jax.jit
def _log_prob_program(model, base, x, theta):
    z, ldj = _chain_eval(model, x, theta, "inv")
    return base.log_prob(z) + ldj


@jax.jit
def _log_prob_program_chunked(model, base, x, theta):
    """Row-chunked inverse fold: the same blocking as the sampling fold,
    for density evaluation at widths × row counts whose activations
    would not fit."""
    rows = x.shape[0]
    c = _FOLD_CHUNK
    pad = (-rows) % c
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        theta = jnp.concatenate(
            [theta, jnp.zeros((pad,) + theta.shape[1:], theta.dtype)])

    def body(carry, i):
        xc = jax.lax.dynamic_slice_in_dim(x, i * c, c)
        tc = jax.lax.dynamic_slice_in_dim(theta, i * c, c)
        z, ldj = _chain_eval(model, xc, tc, "inv")
        return carry, base.log_prob(z) + ldj

    _, lps = jax.lax.scan(body, 0,
                          jnp.arange((rows + pad) // c, dtype=jnp.int32))
    return lps.reshape(-1)[:rows]


@partial(jax.jit, static_argnums=(4,))
def _log_prob_grid_program(model, base, vecs, theta_row, chunk):
    """Chunked tensor-product-grid log-pdf: ONE jitted program that
    `lax.map`s over row chunks, materializing each chunk's grid points
    from mixed-radix indices on device — peak memory is O(chunk·d) +
    the output, never the full (∏lenᵢ, d) grid (reference grid logpdf
    materializes everything, src/Flows.jl:287-331)."""
    lens = [v.shape[0] for v in vecs]
    total = int(np.prod(lens))
    n_chunks = -(-total // chunk)

    def one(cidx):
        flat = cidx * chunk + jnp.arange(chunk)
        rem = flat
        coords = []
        for v in reversed(vecs):  # 'ij' indexing: last axis varies fastest
            coords.append(v[rem % v.shape[0]])
            rem = rem // v.shape[0]
        pts = jnp.stack(coords[::-1], axis=-1)
        th = jnp.broadcast_to(theta_row, (chunk, theta_row.shape[-1]))
        z, ldj = _chain_eval(model, pts, th, "inv")
        return base.log_prob(z) + ldj

    lps = jax.lax.map(one, jnp.arange(n_chunks))
    return lps.reshape(-1)[:total]


@partial(jax.jit, static_argnums=(3, 4, 5))
def _sharded_sweep_draw(base, key, theta_n, total, dtype, sharding):
    """Draw the sweep's base sample ON the mesh (sharding constraint inside
    the program) — a device_put of an eager host-local array would fail on
    a multi-process mesh. Module-level so repeat sweeps reuse the program."""
    r = base.sample(key, (total,), dtype)
    return (jax.lax.with_sharding_constraint(r, sharding),
            jax.lax.with_sharding_constraint(theta_n, sharding))


@jax.jit
def _forward_program(model, z, theta):
    return _chain_eval(model, z, theta, "fwd")


@jax.jit
def _inverse_program(model, x, theta):
    return _chain_eval(model, x, theta, "inv")


class Flow:
    """Flow = model chain + base distribution + θ-metadata + loss histories
    (reference ``Flow`` struct, src/Flows.jl:37-47)."""

    def __init__(
        self,
        model: FlowChain,
        data_or_metadata,
        base=None,
        train_loss: list | None = None,
        valid_loss: list | None = None,
    ):
        if isinstance(data_or_metadata, DataArrays):
            metadata = data_or_metadata.metadata()
        elif isinstance(data_or_metadata, MetaData):
            metadata = data_or_metadata
        else:
            raise TypeError("pass a DataArrays or a MetaData")
        self.model = model
        self.metadata = metadata
        self.base = base if base is not None else StandardNormal(metadata.d)
        self.train_loss: list[float] = list(train_loss or [])
        self.valid_loss: list[float] = list(valid_loss or [])
        # per-epoch counts of batch updates skipped as non-finite
        # (populated by train(skip_nonfinite=True))
        self.skipped_updates: list[int] = []
        # device-resident θ bounds for boundary normalization
        self._theta_min = jnp.asarray(metadata.theta_min)
        self._theta_max = jnp.asarray(metadata.theta_max)

    # -- θ boundary handling (the @flow_wrapper + @unconditional_wrapper
    #    semantics, src/Macros.jl:104-128) --------------------------------
    def prepare_theta(self, theta, batch_shape, dtype=jnp.float32):
        """Broadcast θ to (batch..., n) and min-max normalize it to [0,1].

        Accepts ``None`` (unconditional: zero-width sentinel), a
        scalar/tuple of n values (one θ for every sample, the reference's
        NTuple path, src/Flows.jl:174-185), or an array of shape
        (batch..., n).

        Shape rule (deterministic — no batch-size-dependent flips): any
        scalar / tuple / list / 0-D / 1-D input is ALWAYS one θ-vector of
        the flow's n conditions, broadcast to every sample; per-sample
        conditions must be explicitly shaped (batch..., n). A 1-D array
        whose length isn't n raises (e.g. per-sample scalars for an n=1
        flow must be passed as (batch, 1), not (batch,)).
        """
        n = self.metadata.n
        batch_shape = tuple(batch_shape)
        if theta is None:
            if n:
                raise ValueError(
                    f"this flow is conditional (n={n}); pass theta "
                    "(the unconditional theta=None form is only valid for "
                    "n=0 flows — reference dflt_θ, src/Data.jl:55-65)"
                )
            return jnp.zeros(batch_shape + (0,), dtype)
        if isinstance(theta, (int, float)):
            theta = (theta,)
        theta = jnp.asarray(theta, dtype)
        if theta.ndim <= 1:
            vec = theta.reshape(-1)
            if vec.shape[0] != n:
                raise ValueError(
                    f"theta must have {n} entries, got {vec.shape[0]} "
                    f"(1-D theta is always one condition vector broadcast "
                    f"to the batch; per-sample conditions need shape "
                    f"{batch_shape + (n,)})"
                )
            theta = jnp.broadcast_to(vec, batch_shape + (n,))
        elif theta.shape != batch_shape + (n,):
            raise ValueError(
                f"theta shape {theta.shape} must be {batch_shape + (n,)}"
            )
        if n == 0:
            return theta
        return normalize_input(theta, self._theta_min.astype(dtype),
                               self._theta_max.astype(dtype))

    # -- transforms -------------------------------------------------------
    def forward(self, z, theta=None):
        """latent → data with ldj, θ normalized at the boundary."""
        z = jnp.asarray(z)
        return _forward_program(
            self.model, z, self.prepare_theta(theta, z.shape[:-1], z.dtype)
        )

    def inverse(self, x, theta=None):
        """data → latent with ldj (the reference's Flow-level ``backward``)."""
        x = jnp.asarray(x)
        return _inverse_program(
            self.model, x, self.prepare_theta(theta, x.shape[:-1], x.dtype)
        )

    # reference alias (direction naming per SURVEY.md §2.4.4)
    backward = inverse

    def predict(self, z, theta=None):
        """Transformed sample without ldj (reference ``predict``,
        src/Flows.jl:126)."""
        return self.forward(z, theta)[0]

    # -- sampling ---------------------------------------------------------
    def sample(self, dims, theta=None, *, key=None, dtype=jnp.float32,
               mesh=None):
        """Draw samples of shape (*dims, d) (reference ``sample``,
        src/Flows.jl:157-192; layout flipped from (d, dims...)).

        ``theta``: None, a tuple of n scalars (shared by all draws), or an
        array of shape (*dims, n). ``mesh``: shard the flattened draw axis
        over the mesh ``data`` axis (multi-process-safe: the draw happens
        ON the mesh inside the program).
        """
        if isinstance(dims, int):
            dims = (dims,)
        dims = tuple(int(s) for s in dims)
        if key is None:
            key = jax.random.key(np.random.randint(0, 2**31 - 1))
        if mesh is not None:
            from ..parallel.mesh import data_sharding

            rows = int(np.prod(dims)) if dims else 1
            theta_n = self.prepare_theta(theta, dims, dtype).reshape(
                rows, self.metadata.n)
            r, theta_n = _sharded_sweep_draw(
                self.base, key, theta_n, rows, dtype, data_sharding(mesh, 2)
            )
            out = _sample_program(self.model, None, r, theta_n)
            return out.reshape(dims + (self.metadata.d,))
        r = self.base.sample(key, dims, dtype)
        theta_n = self.prepare_theta(theta, dims, dtype)
        rows = int(np.prod(dims)) if dims else 1
        if self._chunk_fold(rows):
            out = _sample_program_chunked(
                self.model, r.reshape(rows, self.metadata.d),
                jnp.broadcast_to(
                    theta_n, r.shape[:-1] + theta_n.shape[-1:]
                ).reshape(rows, theta_n.shape[-1]))
            return out.reshape(dims + (self.metadata.d,))
        return _sample_program(self.model, None, r, theta_n)

    def _chunk_fold(self, rows: int) -> bool:
        """Chunk the fold when one layer's activations would pass
        ``_FOLD_CHUNK_BYTES`` — unless the fused kernel takes the fold,
        which keeps activations on chip by construction."""
        w = max(_max_conditioner_width(self.model), self.metadata.d)
        return (rows >= 2 * _FOLD_CHUNK
                and rows * w * 4 > _FOLD_CHUNK_BYTES
                and not self._kernel_fold(rows))

    def _kernel_fold(self, rows: int) -> bool:
        from .fused_chain import routes_to_kernel

        return (isinstance(self.model, FlowChain)
                and routes_to_kernel(self.model, rows, self.metadata.d))

    def sample_sweep(self, thetas, n_per_theta: int, *, key=None,
                     dtype=jnp.float32, mesh=None):
        """Conditional sampling sweep over a grid of θ values.

        ``thetas``: (G, n) array (or list of tuples) of conditions.
        Returns draws of shape (G, n_per_theta, d) from ONE jitted
        program — the flattened (G·n_per_theta) particle axis shards
        over ``mesh`` when given (SURVEY.md §7 M4 'sharded sampling
        sweep over a θ grid').
        """
        thetas = jnp.asarray(thetas, dtype)
        if thetas.ndim != 2 or thetas.shape[-1] != self.metadata.n:
            raise ValueError(
                f"thetas must have shape (G, {self.metadata.n})"
            )
        g = thetas.shape[0]
        total = g * n_per_theta
        if key is None:
            key = jax.random.key(np.random.randint(0, 2**31 - 1))
        theta_full = jnp.repeat(thetas, n_per_theta, axis=0)
        theta_n = normalize_input(
            theta_full, self._theta_min.astype(dtype),
            self._theta_max.astype(dtype),
        ) if self.metadata.n else theta_full
        if mesh is not None:
            from ..parallel.mesh import data_sharding

            r, theta_n = _sharded_sweep_draw(
                self.base, key, theta_n, total, dtype, data_sharding(mesh, 2)
            )
        else:
            r = self.base.sample(key, (total,), dtype)
            if self._chunk_fold(total):
                out = _sample_program_chunked(self.model, r, theta_n)
                return out.reshape(g, n_per_theta, self.metadata.d)
        out = _sample_program(self.model, None, r, theta_n)
        return out.reshape(g, n_per_theta, self.metadata.d)

    # -- densities --------------------------------------------------------
    def log_prob(self, x, theta=None, *, grid_chunk: int = 65536,
                 mesh=None):
        """log pdf at x (reference ``logpdf``, src/Flows.jl:272-281).

        ``x`` may also be a tuple of d per-axis vectors — then the log-pdf
        is evaluated on the full tensor-product grid and returned with
        shape (len(x[0]), ..., len(x[d-1])) (src/Flows.jl:287-331); in that
        form a conditional flow requires θ as a tuple of n scalars. Grids
        larger than ``grid_chunk`` rows are evaluated in on-device chunks
        (one fused program; peak memory O(grid_chunk·d) + output), so
        dense grids in d ≥ 4 don't OOM.

        ``mesh`` (array form only): shard the evaluation rows over the
        mesh ``data`` axis — for density sweeps too large for one chip.
        """
        if isinstance(x, (tuple, list)) and all(
            np.ndim(v) == 1 for v in x
        ):
            if mesh is not None:
                raise ValueError("mesh sharding applies to the array form "
                                 "of log_prob, not the grid form")
            return self._log_prob_grid(tuple(x), theta, grid_chunk)
        x = jnp.asarray(x)
        theta_n = self.prepare_theta(theta, x.shape[:-1], x.dtype)
        if mesh is not None:
            from ..parallel.mesh import put_global

            batch_shape = x.shape[:-1]
            rows = int(np.prod(batch_shape)) if batch_shape else 1
            pad = (-rows) % mesh.shape["data"]

            def prep(a, width):
                a = np.asarray(a.reshape(rows, width))
                if pad:
                    a = np.concatenate(
                        [a, np.zeros((pad, width), a.dtype)], 0)
                return put_global(mesh, a)

            lp = _log_prob_program(
                self.model, self.base, prep(x, x.shape[-1]),
                prep(theta_n, self.metadata.n),
            )
            return lp[:rows].reshape(batch_shape)
        batch_shape = x.shape[:-1]
        rows = int(np.prod(batch_shape)) if batch_shape else 1
        if self._chunk_fold(rows):
            lp = _log_prob_program_chunked(
                self.model, self.base, x.reshape(rows, x.shape[-1]),
                jnp.broadcast_to(
                    theta_n, batch_shape + theta_n.shape[-1:]
                ).reshape(rows, theta_n.shape[-1]))
            return lp.reshape(batch_shape)
        return _log_prob_program(self.model, self.base, x, theta_n)

    def _log_prob_grid(self, axes_vectors: tuple, theta, grid_chunk: int):
        d = self.metadata.d
        if len(axes_vectors) != d:
            raise ValueError(f"grid must have {d} axis vectors")
        lens = [len(v) for v in axes_vectors]
        total = int(np.prod(lens))
        if total > grid_chunk:
            vecs = tuple(jnp.asarray(v, jnp.float32) for v in axes_vectors)
            theta_row = self.prepare_theta(theta, (1,))
            lp = _log_prob_grid_program(
                self.model, self.base, vecs, theta_row, int(grid_chunk)
            )
            return lp.reshape(lens)
        grids = jnp.meshgrid(*[jnp.asarray(v) for v in axes_vectors],
                             indexing="ij")
        pts = jnp.stack([g.reshape(-1) for g in grids], axis=-1)
        lp = self.log_prob(pts, theta)
        return lp.reshape(lens)

    def prob(self, x, theta=None):
        """pdf = exp(log_prob) (reference ``pdf``, src/Flows.jl:345-349)."""
        return jnp.exp(self.log_prob(x, theta))

    # reference-name aliases
    logpdf = log_prob
    pdf = prob

    # -- histories --------------------------------------------------------
    @property
    def training_loss(self) -> list[float]:
        """Training-loss history (reference src/Flows.jl:60)."""
        return self.train_loss

    @property
    def validation_loss(self) -> list[float]:
        """Validation-loss history (reference src/Flows.jl:63)."""
        return self.valid_loss

    def summarize(self) -> str:
        return (
            "- model --------------------\n"
            + self.model.summarize()
            + "\n- base distribution --------\n"
            + type(self.base).__name__
        )
