"""Device mesh and sharding utilities (GSPMD data/model parallelism).

The reference is entirely serial (SURVEY.md §2.2); this subsystem is the
TPU-native scaling path the north star mandates: a logical mesh with a
``data`` axis (batch/particle sharding — gradients all-reduce via an
XLA-inserted ``psum`` over ICI) and an optional ``model`` axis (tensor
parallelism for wide conditioner MLPs, BASELINE.json config 3).

Everything composes with ``jax.jit``: place arrays with the shardings
returned here and the GSPMD partitioner inserts the collectives.
Multi-host bootstrap goes through :func:`distributed_init`
(``jax.distributed.initialize``) before any device access.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "shard_params_tp",
    "mlp_tp_specs",
    "distributed_init",
    "global_batch_from_host_local",
    "host_local_slice",
    "host_local_rows",
    "put_global",
    "put_replicated",
]


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = ("data",),
    *,
    devices=None,
) -> Mesh:
    """Build a logical mesh. Default: all devices on one ``data`` axis.

    ``make_mesh((4, 2), ("data", "model"))`` builds a 2-D mesh for
    DP × TP. Axis sizes must multiply to the device count. Axes are
    ``Auto``-typed so the GSPMD partitioner resolves intermediate
    shardings and inserts collectives itself (classic pjit behavior) —
    explicit-mode meshes would demand per-gather out_shardings.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else (n // 1,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    axis_types = (jax.sharding.AxisType.Auto,) * len(axis_names)
    return jax.make_mesh(shape, axis_names, devices=devices,
                         axis_types=axis_types)


def data_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard axis 0 (the batch/particle axis) over the mesh ``data`` axis;
    replicate everything else."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    """Place batch-major arrays with the batch axis sharded over ``data``."""
    out = tuple(
        jax.device_put(a, data_sharding(mesh, np.ndim(a))) for a in arrays
    )
    return out[0] if len(out) == 1 else out


def mlp_tp_specs(n_weights: int) -> tuple[list[P], list[P]]:
    """Explicit Megatron placement for one conditioner MLP with
    ``n_weights`` dense layers: consecutive layer PAIRS are
    (column-parallel, row-parallel) — layer 2k shards its OUTPUT hidden
    axis ``P(None, 'model')`` with its bias sharded ``P('model')``; layer
    2k+1 shards its INPUT axis ``P('model', None)`` with a replicated
    bias, and the GSPMD partitioner inserts exactly ONE psum at each
    row-parallel output (Megatron-LM, Shoeybi et al. 2019). An unpaired
    trailing layer is replicated (its input is already replicated after
    the last psum, so this adds no collectives).

    Returns ``(weight_specs, bias_specs)`` lists of length ``n_weights``.
    """
    w_specs: list[P] = []
    b_specs: list[P] = []
    i = 0
    while i + 1 < n_weights:
        w_specs += [P(None, "model"), P("model", None)]
        b_specs += [P("model"), P()]
        i += 2
    if i < n_weights:
        w_specs.append(P())
        b_specs.append(P())
    return w_specs, b_specs


def shard_params_tp(mesh: Mesh, model):
    """Place a model pytree with conditioner MLPs tensor-parallel over the
    mesh ``model`` axis (wide-emulator configs; small nets can stay
    replicated — pass them through :func:`replicated` instead).

    Each :class:`~densityflows_tpu.ops.mlp.MLP` is placed as a unit via
    :func:`mlp_tp_specs` (column/row pairs, one psum per pair); every
    other leaf — masked autoregressive nets, normalization constants,
    spline params — is replicated. A weight whose sharded dimension isn't
    divisible by the ``model`` axis falls back to replicated.

    TP stays OPT-IN: it has not been measured on cards, and at the
    wide-emulator size (hidden 256) the matmuls are small next to a
    collective's latency; this placement exists for genuinely large
    conditioners.
    """
    from ..ops.mlp import MLP

    def put(leaf, spec):
        try:
            return jax.device_put(leaf, NamedSharding(mesh, spec))
        except ValueError:
            # dimension not divisible by the model-axis size → replicate
            return jax.device_put(leaf, NamedSharding(mesh, P()))

    def place(node):
        if isinstance(node, MLP):
            w_specs, b_specs = mlp_tp_specs(len(node.weights))
            return MLP(
                tuple(put(w, s) for w, s in zip(node.weights, w_specs)),
                tuple(put(b, s) for b, s in zip(node.biases, b_specs)),
                node.activation,
            )
        return jax.tree_util.tree_map(lambda l: put(l, P()), node)

    return jax.tree_util.tree_map(
        place, model, is_leaf=lambda n: isinstance(n, MLP)
    )


def host_local_slice(n_global: int) -> slice:
    """This host's contiguous row range of a globally (evenly) partitioned
    dataset — load only these rows from disk on each host (per-host data
    loading, SURVEY.md §2.2 DP disposition)."""
    p, np_ = jax.process_index(), jax.process_count()
    per = -(-n_global // np_)
    return slice(p * per, min((p + 1) * per, n_global))


def host_local_rows(mesh: Mesh, n_global: int) -> slice:
    """The contiguous global-row range THIS process's devices hold under
    the batch-axis ``data`` sharding of ``mesh`` — the exact slice to pass
    to :func:`global_batch_from_host_local`. Derived from the sharding's
    own device→index map (not assumed), so it stays correct for any mesh
    whose per-process device shards are contiguous; raises otherwise."""
    sharding = NamedSharding(mesh, P("data"))
    idx_map = sharding.addressable_devices_indices_map((n_global,))
    spans = []
    for idx in idx_map.values():
        s = idx[0]
        spans.append((s.start or 0, n_global if s.stop is None else s.stop))
    lo = min(s for s, _ in spans)
    hi = max(e for _, e in spans)
    if sum(e - s for s, e in spans) != hi - lo:
        raise ValueError(
            "this process's shards of the data axis are not contiguous — "
            "reorder the mesh devices so each process owns a contiguous "
            "row range (standard jax.devices() order does)"
        )
    return slice(lo, hi)


def global_batch_from_host_local(mesh: Mesh, host_local: np.ndarray):
    """Assemble a globally-sharded array from each host's local rows.

    Wraps ``jax.make_array_from_process_local_data`` with the batch-axis
    ``data`` sharding: each host contributes its rows, no host ever
    materializes the global array. Single-process: equivalent to
    :func:`shard_batch`.
    """
    sharding = data_sharding(mesh, np.ndim(host_local))
    if jax.process_count() == 1:
        return jax.device_put(host_local, sharding)
    return jax.make_array_from_process_local_data(sharding, host_local)


def put_global(mesh: Mesh, arr: np.ndarray):
    """Place a host array as the batch-axis-sharded GLOBAL array, safely on
    single- AND multi-process meshes: multi-process, each host contributes
    its :func:`host_local_rows` slice via
    ``jax.make_array_from_process_local_data`` (a bare ``device_put`` of
    the global array would try to address other hosts' devices and
    raise). Every process must pass the same global ``arr`` rows it owns."""
    arr = np.ascontiguousarray(arr)
    if jax.process_count() > 1:
        return global_batch_from_host_local(
            mesh, arr[host_local_rows(mesh, arr.shape[0])]
        )
    return jax.device_put(arr, data_sharding(mesh, np.ndim(arr)))


def put_replicated(mesh: Mesh, tree):
    """Place a pytree fully replicated over ``mesh``, safely on single- AND
    multi-process meshes (every process must hold the same host values —
    params/optimizer state built deterministically on each host)."""
    rep = replicated(mesh)
    if jax.process_count() > 1:
        return jax.tree_util.tree_map(
            lambda l: jax.make_array_from_process_local_data(
                rep, np.asarray(l)), tree)
    return jax.device_put(tree, rep)


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bootstrap (``jax.distributed.initialize``). Call once per
    host before any device access; no-ops on single-process runs when no
    coordinator is configured."""
    if coordinator_address is None and num_processes is None:
        import os

        if "JAX_COORDINATOR_ADDRESS" not in os.environ:
            return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
