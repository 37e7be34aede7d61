"""Scaling harness: measured samples/s across mesh sizes.

The north-star protocol (BASELINE.md: ≥80% linear samples/s scaling from
1 chip to N) needs a harness, not a claim. This module runs the SAME
jitted train-step / sampling-sweep on submeshes of growing size with the
per-device batch held constant (weak scaling) and reports throughput and
efficiency vs linear.

Timing method — two-point scan differencing: each workload runs M reps
inside one ``lax.scan`` program at two lengths (M1, M2) and the rate is
Δt/ΔM, which cancels the per-dispatch constant (launch and host
overhead) exactly. Scan bodies reduce over every output element so XLA
cannot dead-code-eliminate the work.

On several cards this measures the collectives between them; on the
CPU-virtual-device test rig it validates that the programs partition and
execute at every mesh size (the standard pjit test path, SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .mesh import data_sharding, make_mesh, put_global, put_replicated

__all__ = ["ScalingPoint", "scaling_report"]

_M1, _M2 = 2, 8


@dataclasses.dataclass(frozen=True)
class ScalingPoint:
    n_devices: int
    train_samples_per_sec: float
    sample_draws_per_sec: float
    train_efficiency: float  # vs linear from the 1-device point
    sample_efficiency: float
    # how each rate was measured: "two-point" (dispatch-cancelled Δt/ΔM,
    # the trustworthy estimator) or "blocked floor" (per-rep blocked rate,
    # a documented UNDER-estimate used only when the two-point signal
    # stayed jitter-dominated after gap widening) — so a reader can tell
    # a real measurement from a floor
    train_method: str = "two-point"
    sample_method: str = "two-point"


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def _scan_rate(make_scan, work_per_rep, args, reps):
    """(work/s, method) via two-point scan differencing (Δt/ΔM over scan
    lengths M1, M2); median over ``reps`` interleaved pairs. A
    non-positive median means the gap drowned in per-call jitter — the
    gap is doubled and the measurement retried (bench.py's _scan_rate
    policy) before falling back to the tagged blocked-floor estimator."""
    m1, m2 = _M1, _M2
    t2s: list[float] = []
    for _ in range(4):
        f1, f2 = make_scan(m1), make_scan(m2)
        jax.block_until_ready(f1(*args))  # compile both lengths
        jax.block_until_ready(f2(*args))
        ds, t2s = [], []
        for _ in range(reps):
            t1 = _timed(f1, *args)
            t2 = _timed(f2, *args)
            ds.append((t2 - t1) / (m2 - m1))
            t2s.append(t2 / m2)
        d = float(np.median(ds))
        if d > 0:
            return work_per_rep / d, "two-point"
        m2 *= 2
    # workload below the timer/dispatch noise floor even at the widest
    # gap (tiny models on the CPU rig) — blocked per-rep rate, an
    # UNDER-estimate, tagged so the report can't pass it off as real
    return work_per_rep / float(np.median(t2s)), "blocked floor"


def scaling_report(
    make_model,
    d: int,
    n_cond: int,
    *,
    per_device_batch: int = 1024,
    device_counts=None,
    reps: int = 5,
    seed: int = 0,
) -> list[ScalingPoint]:
    """Weak-scaling sweep of the jitted train step and the sampling sweep.

    ``make_model(key)`` builds the flow chain; the global batch is
    ``per_device_batch × n_devices`` at every point, sharded over a
    1-axis ``data`` mesh of each size in ``device_counts`` (default:
    powers of two up to the local device count). Rates come from the
    two-point scanned method (module docstring).
    """
    from ..models.distributions import StandardNormal
    from ..train import masked_nll_loss

    all_devices = jax.devices()
    if device_counts is None:
        device_counts = [
            n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(all_devices)
        ]
    if jax.process_count() > 1:
        # a submesh that excludes some process would leave that process
        # with no addressable shards (SPMD requires every process in the
        # job to participate) — sweep only whole-job meshes multi-process;
        # per-chip points come from single-process runs
        full = len(all_devices)
        kept = [n for n in device_counts if n == full]
        if not kept:
            raise ValueError(
                "multi-process scaling_report can only measure the "
                f"full-job mesh ({full} devices); run sub-mesh points "
                "single-process"
            )
        device_counts = kept

    base = StandardNormal(d)
    optimizer = optax.adam(1e-3)
    rng = np.random.default_rng(seed)
    points: list[ScalingPoint] = []
    t1 = s1 = None

    for n_dev in device_counts:
        mesh = make_mesh((n_dev,), ("data",), devices=all_devices[:n_dev])
        batch = per_device_batch * n_dev
        # multi-process-safe placement (same path as train(); each host
        # contributes its rows via make_array_from_process_local_data)
        model = put_replicated(mesh, make_model(jax.random.key(seed)))
        opt_state = put_replicated(mesh, optimizer.init(model))
        x = put_global(mesh, rng.normal(size=(batch, d)).astype(np.float32))
        theta = put_global(
            mesh, rng.uniform(0, 1, size=(batch, n_cond)).astype(np.float32)
        )
        mask = put_global(mesh, np.ones((batch,), np.float32))

        def make_train_scan(m):
            # x/theta/mask are ARGUMENTS, not closure captures: a jit
            # may not close over globally-sharded (non-addressable)
            # arrays on a multi-process mesh
            @jax.jit
            def run(model, opt_state, x, theta, mask):
                def body(c, _):
                    mm, oo = c
                    loss, grads = jax.value_and_grad(masked_nll_loss)(
                        mm, base, x, theta, mask
                    )
                    updates, oo = optimizer.update(grads, oo, mm)
                    mm = optax.apply_updates(mm, updates)
                    return (mm, oo), loss

                _, losses = jax.lax.scan(body, (model, opt_state), None,
                                         length=m)
                return losses[-1]

            return run

        tps, t_method = _scan_rate(make_train_scan, batch,
                                   (model, opt_state, x, theta, mask), reps)

        def make_sample_scan(m):
            @jax.jit
            def run(model, theta, key):
                def body(c, k):
                    r = base.sample(k, (batch,))
                    r = jax.lax.with_sharding_constraint(
                        r, data_sharding(mesh, 2))
                    out = model.forward_(r, theta)
                    return c + jnp.sum(out), None

                tot, _ = jax.lax.scan(body, jnp.float32(0),
                                      jax.random.split(key, m))
                return tot

            return run

        sps, s_method = _scan_rate(
            make_sample_scan, batch, (model, theta, jax.random.key(seed + 1)),
            reps,
        )

        if t1 is None:
            t1, s1 = tps, sps
        points.append(
            ScalingPoint(
                n_dev,
                tps,
                sps,
                tps / (t1 * n_dev),
                sps / (s1 * n_dev),
                t_method,
                s_method,
            )
        )
    return points
