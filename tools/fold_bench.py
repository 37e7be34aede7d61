"""Time the whole-chain fold three ways on the GPU and check parity.

For each shape (4 coupling blocks + normalization, n=8 conditions, 2¹⁸
rows by default) this times ``Flow.log_prob``-style density evaluation
and ``Flow.sample``-style sampling as

- ``kernel``:  the fused Pallas–Triton fold (ops/pallas_chain.py),
- ``straight``: XLA's per-layer fold over all rows,
- ``chunked``: XLA's per-layer fold in 4096-row blocks (lax.scan),

plus the public ``Flow.log_prob`` / ``Flow.sample`` end to end, once as
the router sends them and once with the router held to XLA's fold. Times are medians of ``--reps`` runs ending in
``block_until_ready``, compile excluded. Parity: the kernel and XLA's
default-precision fold, each against the straight fold at
``jax.default_matmul_precision("highest")``.

    python tools/fold_bench.py [--rows 262144] [--reps 7] [--out FILE]

Prints one JSON line per shape; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = (  # (name, d, hidden, joint)
    ("d16_h64_split", 16, 64, False),
    ("d32_h256_split", 32, 256, False),
    ("d32_h256_joint", 32, 256, True),
    ("d128_h512_joint", 128, 512, True),
    # around the crossover, for the router's thresholds
    ("d8_h32_split", 8, 32, False),
    ("d16_h128_split", 16, 128, False),
    ("d32_h64_split", 32, 64, False),
    ("d32_h128_joint", 32, 128, True),
    ("d64_h64_joint", 64, 64, True),
)
N_COND, BLOCKS, CHUNK = 8, 4, 4096


def build_flow(df, jax, d, hidden, joint, seed=0):
    """Random non-identity chain (final conditioner layers damped so
    exp(s) stays O(1) through 8 couplings) wrapped in a Flow."""
    from densityflows_tpu.ops.mlp import MLP

    rng = np.random.default_rng(seed)
    x_ref = rng.normal(size=(4096, d)).astype(np.float32)
    th_ref = rng.uniform(size=(4096, N_COND)).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), BLOCKS)
    chain = df.flow_chain(
        *[df.coupling_block(d, None, n=N_COND, key=k, hidden_dim_s=hidden,
                            hidden_dim_t=hidden, joint_conditioner=joint,
                            zero_init_final=False) for k in keys],
        df.normalization_layer(x_ref, -1.0, 1.0),
    )

    def damp(node):
        if isinstance(node, MLP):
            ws = list(node.weights)
            ws[-1] = ws[-1] * 0.05
            return MLP(tuple(ws), node.biases, node.activation)
        return node

    chain = jax.tree_util.tree_map(damp, chain,
                                   is_leaf=lambda n: isinstance(n, MLP))
    data = df.DataArrays.make(x_ref, th_ref, rng=0)
    return df.Flow(chain, data)


def median_time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure(name, d, hidden, joint, rows, reps):
    import jax
    import jax.numpy as jnp

    import densityflows_tpu as df
    from densityflows_tpu.models import fused_chain as fc

    flow = build_flow(df, jax, d, hidden, joint)
    chain, base = flow.model, flow.base
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(rows, d)).astype(np.float32))
    th_raw = rng.uniform(size=(rows, N_COND)).astype(np.float32)
    th = flow.prepare_theta(jnp.asarray(th_raw), (rows,))

    def chunked(fold):
        def run(c, xx, tt):
            def body(carry, i):
                xc = jax.lax.dynamic_slice_in_dim(xx, i * CHUNK, CHUNK)
                tc = jax.lax.dynamic_slice_in_dim(tt, i * CHUNK, CHUNK)
                return carry, fold(c, xc, tc)
            _, out = jax.lax.scan(body, 0, jnp.arange(rows // CHUNK))
            return jax.tree_util.tree_map(
                lambda a: a.reshape((rows,) + a.shape[2:]), out)
        return run

    def lp_of(fold):
        def run(c, xx, tt):
            z, ldj = fold(c, xx, tt)
            return base.log_prob(z) + ldj
        return run

    inv_kernel = lambda c, xx, tt: fc.apply_fused(c, xx, tt, "inv", True)
    inv_xla = lambda c, xx, tt: fc._jnp_chain(c, xx, tt, "inv", True)
    fwd_kernel = lambda c, zz, tt: fc.apply_fused(c, zz, tt, "fwd", False)
    fwd_xla = lambda c, zz, tt: fc._jnp_chain(c, zz, tt, "fwd", False)

    lp = {"kernel": jax.jit(lp_of(inv_kernel)),
          "straight": jax.jit(lp_of(inv_xla)),
          "chunked": jax.jit(chunked(lp_of(inv_xla)))}

    def sampler(fold):
        @jax.jit
        def run(c, key, tt):
            return fold(c, base.sample(key, (rows,)), tt)
        return run

    sm = {"kernel": sampler(fwd_kernel), "straight": sampler(fwd_xla),
          "chunked": sampler(chunked(fwd_xla))}
    key = jax.random.key(3)
    res = {"shape": name, "d": d, "hidden": hidden, "joint": joint,
           "rows": rows, "n_cond": N_COND, "blocks": BLOCKS}
    t0 = time.perf_counter()
    jax.block_until_ready(lp["kernel"](chain, x, th))
    res["kernel_compile_s"] = time.perf_counter() - t0
    for k in lp:
        res[f"log_prob_{k}_ms"] = 1e3 * median_time(
            lambda: lp[k](chain, x, th), reps)
        res[f"sample_{k}_ms"] = 1e3 * median_time(
            lambda: sm[k](chain, key, th), reps)
    th_dev = jnp.asarray(th_raw)
    res["router_picks_kernel"] = bool(flow._kernel_fold(rows))
    route = fc.use_fused_chain
    for tag, rule in (("flow", route), ("flow_xla", lambda *a: False)):
        fc.use_fused_chain = rule
        try:
            jax.clear_caches()  # the route is read at trace time
            res[f"log_prob_{tag}_ms"] = 1e3 * median_time(
                lambda: flow.log_prob(x, th_dev), reps)
            res[f"sample_{tag}_ms"] = 1e3 * median_time(
                lambda: flow.sample((rows,), th_dev, key=key), reps)
        finally:
            fc.use_fused_chain = route

    with jax.default_matmul_precision("highest"):
        ref_lp = np.asarray(jax.jit(lp_of(inv_xla))(chain, x, th))
        ref_s = np.asarray(sm["straight"](chain, key, th))
    scale = float(np.median(np.abs(ref_lp)))
    for k in ("kernel", "straight"):
        got_lp = np.asarray(lp[k](chain, x, th))
        got_s = np.asarray(sm[k](chain, key, th))
        tag = "kernel" if k == "kernel" else "xla_default"
        res[f"{tag}_log_prob_max_abs_err"] = float(
            np.max(np.abs(got_lp - ref_lp)))
        res[f"{tag}_sample_max_abs_err"] = float(
            np.max(np.abs(got_s - ref_s)))
        res[f"{tag}_finite"] = bool(np.isfinite(got_lp).all()
                                    and np.isfinite(got_s).all())
    res["median_abs_log_prob"] = scale
    res["peak_bytes_in_use"] = (jax.devices()[0].memory_stats()
                                or {}).get("peak_bytes_in_use")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--shapes", default=",".join(s[0] for s in SHAPES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from densityflows_tpu.utils.runtime import (
        enable_compile_cache, gpu_name_power_limit, require_gpu)

    enable_compile_cache(ROOT)
    dev = require_gpu()
    import jax

    head = {"device_kind": dev.device_kind, "jax": jax.__version__,
            "nvidia_smi": gpu_name_power_limit()}
    print(json.dumps(head), flush=True)
    lines = [head]
    wanted = set(args.shapes.split(","))
    for name, d, hidden, joint in SHAPES:
        if name in wanted:
            r = measure(name, d, hidden, joint, args.rows, args.reps)
            print(json.dumps(r), flush=True)
            lines.append(r)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
