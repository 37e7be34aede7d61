"""Out-of-core streaming input pipeline + streaming trainer.

The whole-run program (:func:`densityflows_tpu.train.train`) uploads the
whole dataset to device memory once — right for datasets that fit. This module is
the path for datasets that don't: a host-side loader that assembles
shuffled batches from a (possibly memory-mapped) array with the native
threaded gather (``native/loader.cpp``), double-buffers them on a
background thread, and feeds the per-batch jitted train step
(:func:`~densityflows_tpu.train.make_train_step`) so host assembly of
batch k+1 overlaps device compute of batch k.

No reference counterpart: DensityFlows.jl's ``Flux.DataLoader`` shuffles
an in-memory array (/root/reference/src/Flows.jl:394) and has no
streaming or multi-host story. Epoch semantics match the reference
(fresh shuffle per epoch, partial final batch kept via mask, per-epoch
train/valid NLL pushed to the histories, src/Flows.jl:419-437).

Multi-host: pass ``host_id``/``num_hosts`` and each host streams its own
disjoint row shard of the SAME deterministic global permutation —
per-host loading with global-shuffle equivalence (SURVEY.md §7
"Multi-host input pipeline + determinism").
"""

from __future__ import annotations

import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np

from . import native

__all__ = ["StreamingLoader", "train_streaming"]


_mask_sum = jax.jit(jnp.sum)


class StreamingLoader:
    """Deterministic, double-buffered batch loader over host arrays.

    ``x`` (n, d) and optional ``theta`` (n, k) may be NumPy arrays or
    memmaps (``np.load(..., mmap_mode='r')``). Iterating an epoch yields
    ``(x_batch, theta_batch, mask)`` with static shapes; the mask zeroes
    padded rows of the final partial batch.
    """

    def __init__(
        self,
        x,
        theta=None,
        *,
        batchsize: int = 64,
        shuffle: bool = True,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
    ):
        if x.ndim != 2:
            raise ValueError(f"x must be (rows, d), got shape {x.shape}")
        if theta is None:
            theta = np.zeros((x.shape[0], 0), np.float32)
        if theta.shape[0] != x.shape[0]:
            raise ValueError(
                f"x has {x.shape[0]} rows but theta has {theta.shape[0]}"
            )
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.x, self.theta = x, theta
        self.batchsize = int(batchsize)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.host_id, self.num_hosts = int(host_id), int(num_hosts)
        self.prefetch = int(prefetch)
        self._epoch = 0

    @property
    def _rows_per_host_padded(self) -> int:
        # ceil split: every host is sized for the SAME padded row count,
        # so every host runs the SAME number of batches per epoch —
        # unequal step counts would deadlock SPMD collectives the moment
        # this loader composes with a mesh (hosts with fewer real rows
        # emit fully-masked padding batches instead)
        return -(-self.x.shape[0] // self.num_hosts)

    @property
    def rows_per_host(self) -> int:
        # REAL rows this host holds (its contiguous ceil-split chunk of
        # the global permutation; late hosts may hold fewer)
        n = self.x.shape[0]
        per = self._rows_per_host_padded
        lo = min(self.host_id * per, n)
        return min(lo + per, n) - lo

    @property
    def batches_per_epoch(self) -> int:
        # identical on every host (lockstep invariant)
        return -(-self._rows_per_host_padded // self.batchsize)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = self.x.shape[0]
        if self.shuffle:
            order = native.shuffle(self.seed * 0x9E3779B9 + epoch + 1, n)
        else:
            order = np.arange(n, dtype=np.int64)
        per = self._rows_per_host_padded
        lo = min(self.host_id * per, n)
        hi = min(lo + per, n)
        return order[lo:hi]

    def _assemble(self, idx: np.ndarray):
        b = self.batchsize
        k = len(idx)
        mask = np.zeros((b,), np.float32)
        mask[:k] = 1.0
        if k < b:
            idx = np.concatenate([idx, np.zeros((b - k,), np.int64)])
        return (
            native.gather_rows(self.x, idx),
            native.gather_rows(self.theta, idx),
            mask,
        )

    def epoch(self, epoch: int | None = None):
        """Iterate one epoch's batches, assembled on a background thread."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = self._epoch_order(epoch)
        # iterate the PADDED range so every host yields the same batch
        # count; starts beyond this host's real rows give all-masked
        # batches (order[s:s+b] is empty → mask all zeros)
        starts = range(0, self._rows_per_host_padded, self.batchsize)
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        sentinel = object()

        def producer():
            try:
                for s in starts:
                    q.put(self._assemble(order[s : s + self.batchsize]))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()

    def __iter__(self):
        return self.epoch()


def train_streaming(
    flow,
    x,
    theta=None,
    optimizer=None,
    opt_state=None,
    *,
    epochs: int = 10,
    batchsize: int = 64,
    shuffle: bool = True,
    seed: int = 0,
    valid_data: tuple | None = None,
    verbose: bool = True,
    host_id: int | None = None,
    num_hosts: int | None = None,
    mesh=None,
    metrics_log: str | None = None,
):
    """Stream-train a flow from host (possibly memory-mapped) arrays.

    θ is normalized per-batch via the flow's metadata (same boundary
    contract as ``train``, src/Flows.jl:391-392); raw arrays stay on the
    host. ``valid_data = (x_valid, theta_valid)`` (raw, un-normalized)
    adds a per-epoch validation NLL. Returns ``opt_state``.

    ``mesh``: shard each batch over the mesh ``data`` axis — the gradient
    psum is inserted by GSPMD, so streaming composes with DP. On a
    multi-process mesh each host streams ITS OWN loader shard
    (``host_id``/``num_hosts`` default to the process index/count) and
    the global batch of ``batchsize × num_hosts`` rows is assembled with
    ``jax.make_array_from_process_local_data``; the loader's ceil-split
    guarantees every host runs the SAME batch count per epoch (lockstep —
    unequal step counts would deadlock the psum).
    """
    from .data import normalize_input
    from .train import make_train_step, _default_adam, _eval_nll_jit

    multiproc = mesh is not None and jax.process_count() > 1
    if host_id is None:
        host_id = jax.process_index() if multiproc else 0
    if num_hosts is None:
        num_hosts = jax.process_count() if multiproc else 1
    if multiproc and num_hosts != jax.process_count():
        raise ValueError(
            f"on a multi-process mesh num_hosts ({num_hosts}) must equal "
            f"jax.process_count() ({jax.process_count()})"
        )

    if optimizer is None:
        optimizer = _default_adam()
    step = make_train_step(optimizer)
    loader = StreamingLoader(
        x, theta, batchsize=batchsize, shuffle=shuffle, seed=seed,
        host_id=host_id, num_hosts=num_hosts,
    )

    batch_sharding = mask_sharding = None
    if mesh is not None:
        from .parallel.mesh import data_sharding, put_replicated

        batch_sharding = data_sharding(mesh, 2)
        mask_sharding = data_sharding(mesh, 1)
        if multiproc:
            flow.model = put_replicated(mesh, flow.model)
            if opt_state is not None:
                opt_state = put_replicated(mesh, opt_state)

    def place(arr, sharding):
        arr = np.ascontiguousarray(arr)
        if sharding is None:
            return jnp.asarray(arr)
        if multiproc:
            return jax.make_array_from_process_local_data(sharding, arr)
        return jax.device_put(arr, sharding)

    model = flow.model
    if opt_state is None:
        opt_state = optimizer.init(model)
    md = flow.metadata

    def norm_theta(th):
        return normalize_input(th, md.theta_min, md.theta_max)

    xv = thv = None
    if valid_data is not None:
        xv = jnp.asarray(valid_data[0])
        thv_raw = valid_data[1]
        if thv_raw is None:
            thv_raw = np.zeros((valid_data[0].shape[0], 0), np.float32)
        thv = jnp.asarray(norm_theta(np.asarray(thv_raw)))

    logger = None
    if metrics_log is not None:
        from .utils.logging import MetricsLogger

        logger = MetricsLogger(metrics_log)

    for e in range(epochs):
        losses, weights = [], []
        for xb, thb, mask in loader.epoch(e):
            mask_g = place(mask, mask_sharding)
            model, opt_state, loss = step(
                model, opt_state, flow.base,
                place(xb, batch_sharding),
                place(norm_theta(thb), batch_sharding),
                mask_g,
            )
            # keep losses on device — a float() here would sync per batch
            # and serialize host assembly against device compute
            losses.append(loss)
            if multiproc:
                # the loss is the GLOBAL masked NLL (psum'd in-program), so
                # the epoch weighting needs the GLOBAL mask sum
                weights.append(_mask_sum(mask_g))
            else:
                weights.append(float(mask.sum()))
        if multiproc:
            weights = [float(np.asarray(w)) for w in weights]
        w = np.asarray(weights)
        train_nll = float(np.dot(np.asarray(losses), w) / max(w.sum(), 1.0))
        flow.model = model
        flow.train_loss.append(train_nll)
        extras = {}
        if xv is not None:
            vl = float(_eval_nll_jit(model, flow.base, xv, thv))
            flow.valid_loss.append(vl)
            extras["valid_nll"] = vl
        if logger is not None:
            logger.write(epoch=len(flow.train_loss), train_nll=train_nll,
                         **extras)
        if verbose:
            msg = f"epoch: {len(flow.train_loss)} | train_loss = {train_nll}"
            if xv is not None:
                msg += f", valid_loss = {extras['valid_nll']}"
            print(msg)
    return opt_state

