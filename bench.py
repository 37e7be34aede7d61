"""Benchmark: training, sampling and inference rates on one GPU.

Runs each workload through the public API (``import densityflows_tpu as
df``) and prints ONE JSON line with its rates, the device kind and the
card's power limit:

- reference 5-D config (README): ``df.train`` samples/s, final NLL after
  50 epochs, ``Flow.sample`` draws/s at 2²⁰ draws;
- wide emulator (d=32, n=8, h=256, 4 joint blocks, batch 8192, 2²⁰
  resident rows): ``df.train`` samples/s in f32 and mixed precision,
  ``Flow.sample`` / ``Flow.log_prob`` rows/s at 2¹⁸;
- d=128 (h=512, batch 4096): ``df.train`` samples/s, ``sample_sweep``
  draws/s over a 64-point θ grid;
- ``run_smc`` particle-steps/s over the trained reference flow;
- the importance-weighted SNPE train step, samples/s;
- ``train_streaming`` rows/s from a host array.

Every time is the median of ``REPS`` calls ending in
``block_until_ready`` (or a host fetch), after a warm-up call that
compiles; compile time is not in any rate. Utilization figures divide
conditioner-matmul FLOPs by the published peak of the device kind, from
``PEAKS``. The script fails on a host without a GPU and on a device
kind that is not in ``PEAKS``.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 5

# Dense peaks per card, no sparsity (NVIDIA H100 data sheet: SXM and
# PCIe parts; the H200 shares the SXM part's compute and differs in
# memory bandwidth), keyed by a substring of ``device_kind``.
PEAKS = {
    "H100 PCIe": {"bf16_flops": 756e12, "tf32_flops": 378e12,
                  "f32_flops": 51e12, "hbm_bytes_per_s": 2.0e12},
    "H100": {"bf16_flops": 989e12, "tf32_flops": 495e12,
             "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
    "H200": {"bf16_flops": 989e12, "tf32_flops": 495e12,
             "f32_flops": 67e12, "hbm_bytes_per_s": 4.8e12},
}


def device_peaks(device_kind: str) -> dict:
    """The peak table entry for a ``device_kind`` such as
    ``"NVIDIA H100 80GB HBM3"``; an unknown device is an error."""
    for name, peaks in PEAKS.items():
        if name.lower() in device_kind.lower():
            return peaks
    raise KeyError(f"no published peaks for device kind {device_kind!r}")


def median_seconds(fn, reps=REPS):
    """Median wall time of ``fn()`` (which must block on its result)
    over ``reps`` calls, after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def mlp_flops_per_sample(model):
    """Conditioner-matmul FLOPs for one sample's forward pass: 2·Σ|W|
    over every dense layer of every conditioner MLP."""
    import jax
    from densityflows_tpu.ops.mlp import MLP

    nodes = jax.tree_util.tree_flatten(
        model, is_leaf=lambda n: isinstance(n, MLP))[0]
    return sum(2 * int(np.prod(w.shape)) for n in nodes
               if isinstance(n, MLP) for w in n.weights)


def emulator(df, jax, rows, d, n_cond, hidden, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_cond, d)).astype(np.float32)
    th = rng.uniform(size=(rows, n_cond)).astype(np.float32)
    x = (np.sin(th @ a) + 0.3 * rng.standard_normal(
        (rows, d), dtype=np.float32)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    keys = jax.random.split(jax.random.key(seed), 4)
    chain = df.flow_chain(
        *[df.coupling_block(d, None, n=n_cond, key=k, hidden_dim_s=hidden,
                            hidden_dim_t=hidden, joint_conditioner=True)
          for k in keys],
        df.normalization_layer(x[:4096], -1.0, 1.0),
    )
    return data, chain, x, th


def train_rate(df, jax, flow_fn, data, *, epochs, batch, **kw):
    """samples/s of ``df.train`` (same program every call)."""
    n = len(data.partition.training)

    def run():
        df.train(flow_fn(), data, epochs=epochs, batchsize=batch,
                 verbose=False, key=jax.random.key(1), **kw)

    return epochs * n / median_seconds(run)


def bench_reference(df, jax, jnp, out):
    dat = np.load(os.path.join(ROOT, "tests", "fixtures", "datatest.npz"))
    x, th = dat["x"], dat["theta"]
    data = df.DataArrays.make(x, th, rng=0)
    ks = jax.random.split(jax.random.key(0), 3)

    def build():
        return df.Flow(df.flow_chain(
            *[df.coupling_layer(data, m, hidden_dim_s=16, hidden_dim_t=16,
                                key=k)
              for m, k in zip(([0, 1, 2], [2, 3, 4], [4, 0, 1]), ks)],
            df.normalization_layer(x, -1.0, 1.0)), data)

    out["ref_train_samples_per_sec"] = train_rate(
        df, jax, build, data, epochs=50, batch=64)
    flow = build()
    df.train(flow, data, epochs=50, verbose=False, key=jax.random.key(1))
    out["final_train_nll"] = flow.train_loss[-1]
    n = 1 << 20
    t = median_seconds(lambda: flow.sample(
        (n,), (-1.0,), key=jax.random.key(2)).block_until_ready())
    out["ref_sample_draws_per_sec"] = n / t
    return flow


def bench_wide(df, jax, jnp, out, peaks):
    data, chain, x, th = emulator(df, jax, 1 << 20, 32, 8, 256, seed=3)
    build = lambda: df.Flow(chain, data)
    fl = mlp_flops_per_sample(chain)
    for mp, peak in ((False, "tf32_flops"), (True, "bf16_flops")):
        tag = "wide_mixed" if mp else "wide"
        sps = train_rate(df, jax, build, data, epochs=2, batch=8192,
                         mixed_precision=mp)
        out[f"{tag}_train_samples_per_sec"] = sps
        # training ≈ 3× the forward conditioner FLOPs
        out[f"{tag}_train_mfu"] = sps * 3 * fl / peaks[peak]
    flow = build()
    rows = 1 << 18
    xq, thq = jnp.asarray(x[:rows]), jnp.asarray(th[:rows])
    out["wide_sample_draws_per_sec"] = rows / median_seconds(
        lambda: flow.sample((rows,), thq, key=jax.random.key(5))
        .block_until_ready())
    out["wide_log_prob_rows_per_sec"] = rows / median_seconds(
        lambda: flow.log_prob(xq, thq).block_until_ready())
    out["wide_fold_uses_kernel"] = bool(flow._kernel_fold(rows))
    out["wide_flops_per_sample_fwd"] = fl


def bench_d128(df, jax, jnp, out, peaks):
    data, chain, _, _ = emulator(df, jax, 1 << 19, 128, 8, 512, seed=6)
    build = lambda: df.Flow(chain, data)
    fl = mlp_flops_per_sample(chain)
    sps = train_rate(df, jax, build, data, epochs=1, batch=4096)
    out["d128_train_samples_per_sec"] = sps
    out["d128_train_mfu"] = sps * 3 * fl / peaks["tf32_flops"]
    flow = build()
    thetas = np.random.default_rng(8).uniform(size=(64, 8)).astype(
        np.float32)
    per = 4096
    out["d128_sweep_draws_per_sec"] = 64 * per / median_seconds(
        lambda: flow.sample_sweep(thetas, per, key=jax.random.key(9))
        .block_until_ready())


def bench_inference(df, jax, jnp, out, ref_flow):
    import optax

    n_p, steps = 1 << 17, 16
    theta_n = ref_flow.prepare_theta((-1.0,), (n_p,))

    def log_p(xx):
        z, ldj = ref_flow.model.inverse(xx, theta_n)
        return ref_flow.base.log_prob(z) + ldj

    t = median_seconds(lambda: df.run_smc(
        log_p, d=5, n_particles=n_p, n_steps=steps,
        key=jax.random.key(4))[0].block_until_ready())
    out["smc_particle_steps_per_sec"] = n_p * steps / t

    d_th, n_sum, batch = 5, 5, 4096
    rng = np.random.default_rng(3)
    ks = jax.random.split(jax.random.key(6), 3)
    post = df.flow_chain(
        *[df.coupling_layer(d_th, m, n=n_sum, key=k, hidden_dim_s=64,
                            hidden_dim_t=64)
          for m, k in zip(([0, 1, 2], [2, 3, 4], [4, 0, 1]), ks)])
    base = df.StandardNormal(d_th)
    opt = optax.adam(1e-3)
    wstep = df.make_weighted_train_step(opt)
    th_b = jnp.asarray(rng.normal(size=(batch, d_th)).astype(np.float32))
    x_b = jnp.asarray(rng.uniform(size=(batch, n_sum)).astype(np.float32))
    w_b = jnp.asarray(rng.uniform(0.5, 2.0, size=(batch,)).astype(
        np.float32))
    state = {"m": post, "o": opt.init(post)}

    def step():
        state["m"], state["o"], loss = wstep(state["m"], state["o"], base,
                                             th_b, x_b, w_b)
        loss.block_until_ready()

    out["snpe_weighted_step_samples_per_sec"] = batch / median_seconds(
        step, reps=50)


def bench_streaming(df, jax, out):
    rows, d, n_cond = 1 << 20, 32, 8
    data, chain, x, th = emulator(df, jax, rows, d, n_cond, 256, seed=12)
    flow = df.Flow(chain, data)
    df.train_streaming(flow, x[:8192], th[:8192], epochs=1, batchsize=8192,
                       verbose=False)  # compile
    t0 = time.perf_counter()
    df.train_streaming(flow, x, th, epochs=1, batchsize=8192, verbose=False)
    out["stream_train_rows_per_sec"] = rows / (time.perf_counter() - t0)


def main():
    sys.path.insert(0, ROOT)
    from densityflows_tpu.utils.runtime import (
        enable_compile_cache, gpu_name_power_limit, require_gpu)

    enable_compile_cache(ROOT)
    dev = require_gpu()
    peaks = device_peaks(dev.device_kind)
    import jax
    import jax.numpy as jnp

    import densityflows_tpu as df

    out = {}
    ref_flow = bench_reference(df, jax, jnp, out)
    bench_wide(df, jax, jnp, out, peaks)
    bench_d128(df, jax, jnp, out, peaks)
    bench_inference(df, jax, jnp, out, ref_flow)
    bench_streaming(df, jax, out)
    print(json.dumps({
        "metric": "ref_train_samples_per_sec",
        "value": out["ref_train_samples_per_sec"],
        "unit": "samples/s",
        **out,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "name_power_limit": gpu_name_power_limit(),
        "peaks": peaks,
        "timing": f"median of {REPS} calls after a compiling warm-up",
    }))


if __name__ == "__main__":
    main()
