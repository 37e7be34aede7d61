"""End-to-end smoke run of the flow engine on one GPU.

Drives the library's main path through its public surface
(``import densityflows_tpu as df``) at the widths of the configurations
it supports, checks every result against a plain reference, and prints
one line per phase followed by a last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (data from fixed seeds; only ``tests/fixtures/datatest.npz`` is
read from disk):

1. reference 5-D config: 50 epochs of ``df.train``, final NLL, 2²⁰ draws'
   moments against the fixture;
2. wide emulator (d=32, n=8, h=256, 4 joint blocks): ``df.train`` in f32
   and mixed precision against a step-loop reference, ``Flow.log_prob`` /
   ``Flow.sample`` at 2¹⁸ rows against the ``highest``-precision fold;
   then the same at d=32, h=64 with split conditioners, where the router
   sends the fold to the Pallas–Triton kernel;
3. d=128 (h=512, 4 joint blocks): one training epoch, a 16-point θ sweep,
   and log-densities on the sweep;
4. ``run_smc`` and ``fit_posterior`` over the trained reference flow;
5. ``train_streaming`` over a 2²² × 40 host memmap;
6. ``save_flow`` / ``load_flow`` round trip.

``--four-cards`` runs only the data-parallel path on four local cards
(``train(mesh=...)``, ``sample_sweep(mesh=...)``, sharded resampling),
each against its one-card counterpart.

    python chip_smoke.py [--four-cards]

Exits non-zero, printing no result line, when JAX finds no GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")  # scratch files, under the checkout

# sizes (rows) of each phase's data
REF_DRAWS = 1 << 20
WIDE_ROWS = 1 << 20
FOLD_ROWS = 1 << 18
D128_ROWS = 1 << 19
SWEEP_PER_THETA = 1 << 14
SMC_PARTICLES = 131072
POSTERIOR_PAIRS = 1 << 16
STREAM_ROWS = 1 << 22
DP_ROWS = 1 << 20
RESAMPLE_ROWS = 1 << 20

# phase-local compile accounting (jax.monitoring backend-compile events)
_COMPILE_S = [0.0]


def _on_duration(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE_S[0] += duration


def _peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def run_phase(name, fn):
    """Run one phase; print its line (name, shapes, compile and run
    seconds, parity beside tolerance, peak bytes). Any failure raises."""
    c0, t0 = _COMPILE_S[0], time.perf_counter()
    info = fn()
    wall = time.perf_counter() - t0
    compile_s = _COMPILE_S[0] - c0
    line = {"phase": name, **info, "compile_s": round(compile_s, 3),
            "run_s": round(max(wall - compile_s, 0.0), 3),
            "peak_bytes_in_use": _peak_bytes()}
    print(json.dumps(line), flush=True)
    return line


def train_samples_per_s(df, flow, data, **kw):
    """XLA train rate of a ``df.train`` call whose program is compiled
    already, on a fresh ``flow``: epochs × training rows / wall seconds."""
    import jax

    t0 = time.perf_counter()
    df.train(flow, data, verbose=False, **kw)
    jax.block_until_ready(flow.model)
    n_train = len(data.partition.training)
    return kw["epochs"] * n_train / (time.perf_counter() - t0)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def parity(name, got, want, tol):
    """Elementwise relative parity: max |got − want| / (1 + |want|) ≤ tol
    (a row's rounding error grows with its magnitude)."""
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)
                       / (1.0 + np.abs(want))))
    check(np.isfinite(err) and err <= tol, f"{name}: max rel err {err} > {tol}")
    return {f"{name}_max_rel_err": err, f"{name}_tol": tol}


# ------------------------------------------------------------- references

def hand_adam_epoch(model, base, x, th, key, batch, lr=1e-3, b1=0.9,
                    b2=0.999, eps=1e-8):
    """One epoch of the plain reference: a Python loop of single jitted
    steps — ``jax.grad`` of the masked NLL in float32 at ``highest``
    precision, Adam written out — over train()'s shuffle and batches.
    Returns the model and its full-split NLL."""
    import jax
    import jax.numpy as jnp

    def nll(m, xb, tb, mb):
        z, ldj = m.inverse(xb, tb)
        return -jnp.sum((base.log_prob(z) + ldj) * mb) / jnp.sum(mb)

    @jax.jit
    def step(m, mu, nu, t, xb, tb, mb):
        with jax.default_matmul_precision("highest"):
            g = jax.grad(nll)(m, xb, tb, mb)
        tm = jax.tree_util.tree_map
        mu = tm(lambda a, b: b1 * a + (1 - b1) * b, mu, g)
        nu = tm(lambda a, b: b2 * a + (1 - b2) * b * b, nu, g)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        m = tm(lambda p, a, b: p - lr * (a / c1) / (jnp.sqrt(b / c2) + eps),
               m, mu, nu)
        return m, mu, nu

    @jax.jit
    def full_nll(m, xx, tt):
        with jax.default_matmul_precision("highest"):
            return nll(m, xx, tt, jnp.ones(xx.shape[0]))

    n = x.shape[0]
    n_b = -(-n // batch)
    perm = np.asarray(jax.random.permutation(key, n))
    idx = np.zeros(n_b * batch, np.int64)
    idx[:n] = perm
    zeros = lambda: jax.tree_util.tree_map(jnp.zeros_like, model)
    mu, nu = zeros(), zeros()
    for b in range(n_b):
        i = jnp.asarray(idx[b * batch:(b + 1) * batch])
        mb = jnp.asarray((np.arange(b * batch, (b + 1) * batch) < n)
                         .astype(np.float32))
        model, mu, nu = step(model, mu, nu, b + 1, x[i], th[i], mb)
    return model, float(full_nll(model, x, th))


def plain_fold(chain, y, th, dirn, with_ldj):
    """The per-layer ``ops/coupling.py`` fold at ``highest`` precision."""
    import jax
    from densityflows_tpu.models.fused_chain import _jnp_chain

    with jax.default_matmul_precision("highest"):
        return jax.jit(_jnp_chain, static_argnums=(3, 4))(
            chain, y, th, dirn, with_ldj)


# ---------------------------------------------------------------- configs

def wide_chain(df, jax, d, n_cond, hidden, x_ref, seed=0, blocks=4,
               joint=True):
    keys = jax.random.split(jax.random.key(seed), blocks)
    return df.flow_chain(
        *[df.coupling_block(d, None, n=n_cond, key=k, hidden_dim_s=hidden,
                            hidden_dim_t=hidden, joint_conditioner=joint)
          for k in keys],
        df.normalization_layer(x_ref, -1.0, 1.0),
    )


def emulator_data(rows, d, n_cond, seed):
    """Conditional Gaussian emulator data: x = sin(θA) + θB + 0.3·ε."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_cond, d)).astype(np.float32)
    b = rng.normal(size=(n_cond, d)).astype(np.float32) * 0.5
    th = rng.uniform(0, 1, size=(rows, n_cond)).astype(np.float32)
    x = np.sin(th @ a) + th @ b
    x += 0.3 * rng.standard_normal(size=(rows, d), dtype=np.float32)
    return x.astype(np.float32), th


def perturb(jax, chain, scale=0.01, seed=9):
    """Give zero-initialized final conditioner layers small random
    weights, so folds exercise every conditioner path."""
    from densityflows_tpu.ops.mlp import MLP

    keys = iter(jax.random.split(jax.random.key(seed), 256))

    def f(m):
        if not isinstance(m, MLP):
            return m
        w = m.weights[-1]
        w = w + scale * jax.random.normal(next(keys), w.shape, w.dtype)
        return MLP(m.weights[:-1] + (w,), m.biases, m.activation)

    return jax.tree_util.tree_map(f, chain,
                                  is_leaf=lambda m: isinstance(m, MLP))


# ----------------------------------------------------------------- phases

def phase_reference(df, jax, state):
    dat = np.load(os.path.join(ROOT, "tests", "fixtures", "datatest.npz"))
    x, th = dat["x"], dat["theta"]
    data = df.DataArrays.make(x, th, rng=0)
    ks = jax.random.split(jax.random.key(0), 3)
    build = lambda: df.Flow(df.flow_chain(
        *[df.coupling_layer(data, m, hidden_dim_s=16, hidden_dim_t=16,
                            key=k)
          for m, k in zip(([0, 1, 2], [2, 3, 4], [4, 0, 1]), ks)],
        df.normalization_layer(x, -1.0, 1.0),
    ), data)
    flow = build()
    kw = dict(epochs=50, batchsize=64, key=jax.random.key(1))
    df.train(flow, data, verbose=False, **kw)
    rate = train_samples_per_s(df, build(), data, **kw)
    nll = flow.train_loss[-1]
    check(nll <= 3.3, f"final train NLL {nll} > 3.3")
    s = np.asarray(flow.sample((REF_DRAWS,), (-1.0,), key=jax.random.key(2)))
    xr = x[th[:, 0] == -1]
    # 500 fixture rows: moment standard error ≈ 0.045 σ, plus the bias of
    # a capacity-limited flow (README config)
    dmean = float(np.max(np.abs(s.mean(0) - xr.mean(0)) / xr.std(0)))
    sratio = s.std(0) / xr.std(0)
    check(np.isfinite(s).all(), "non-finite draws")
    check(dmean <= 0.25, f"sample mean off by {dmean} σ")
    check(np.all((sratio > 0.8) & (sratio < 1.25)), f"std ratio {sratio}")
    state["ref_flow"], state["ref_x"] = flow, x
    return {"shapes": "d=5 n=1 h=16 x3 couplings + norm, batch 64, "
                      f"50 epochs; {REF_DRAWS} draws",
            "final_train_nll": nll, "final_train_nll_tol": 3.3,
            "train_samples_per_s": rate,
            "sample_mean_max_dev_sigma": dmean, "sample_mean_tol": 0.25,
            "sample_std_ratio": [float(r) for r in sratio],
            "sample_std_ratio_tol": [0.8, 1.25]}


def phase_wide(df, jax, state):
    import jax.numpy as jnp

    d, n_cond, hidden, batch = 32, 8, 256, 8192
    x, th = emulator_data(WIDE_ROWS, d, n_cond, seed=3)
    data = df.DataArrays.make(x, th, rng=0)
    build = lambda: df.Flow(wide_chain(df, jax, d, n_cond, hidden, x[:4096]),
                            data)
    key = jax.random.key(4)
    out = {"shapes": f"d={d} n={n_cond} h={hidden} 4 joint blocks + norm, "
                     f"{x.shape[0]} rows, batch {batch}, 2 epochs"}
    ref_flow = build()
    xt, tht = (jnp.asarray(a) for a in
               data.normalized_training_data(ref_flow.metadata))
    _, ref_nll = hand_adam_epoch(ref_flow.model, ref_flow.base, xt, tht,
                                 jax.random.split(key, 2)[0], batch)
    del xt, tht
    out["reference_epoch1_nll"] = ref_nll
    # f32 dots run as TF32 on the GPU (about 3 decimal digits): over an
    # epoch of Adam steps the trajectories drift apart at that level;
    # bf16 conditioner passes (mixed precision) keep about 2 digits
    for mp, tol in ((False, 0.02), (True, 0.1)):
        flow = build()
        df.train(flow, data, epochs=2, batchsize=batch, verbose=False,
                 key=key, mixed_precision=mp)
        h = np.asarray(flow.train_loss)
        check(np.isfinite(h).all(), f"non-finite history {h}")
        tag = "mixed" if mp else "f32"
        out.update(parity(f"train_{tag}_epoch1_nll", h[0], ref_nll, tol))
        out[f"train_{tag}_history"] = h.tolist()
        out[f"train_{tag}_samples_per_s"] = train_samples_per_s(
            df, build(), data, epochs=2, batchsize=batch, key=key,
            mixed_precision=mp)
    state["wide_flow"] = flow

    rows = FOLD_ROWS
    tflow = df.Flow(perturb(jax, flow.model), data)
    xq = jnp.asarray(x[:rows])
    thq = jnp.asarray(th[:rows])
    out["fold_router_picks_kernel"] = bool(tflow._kernel_fold(rows))
    lp = tflow.log_prob(xq, thq)
    thn = tflow.prepare_theta(thq, (rows,))
    z, ldj = plain_fold(tflow.model, xq, thn, "inv", True)
    lp_ref = tflow.base.log_prob(z) + ldj
    # TF32 operand rounding (~1e-3 relative per dot) through 8 trained
    # couplings: the worst of 2^18 rows measured 9.7e-3 on an H100, and
    # cuBLAS may pick other TF32 algorithms from run to run
    out.update(parity("log_prob", lp, lp_ref, 3e-2))
    skey = jax.random.key(5)
    s = tflow.sample((rows,), thq, key=skey)
    r = tflow.base.sample(skey, (rows,))
    s_ref = plain_fold(tflow.model, r, thn, "fwd", False)
    out.update(parity("sample", s, s_ref, 1e-2))
    return out


def phase_fold_kernel(df, jax, state):
    """Bulk ``log_prob`` / ``sample`` where the router picks the fold
    kernel (d=32, h=64 split conditioners), against the plain fold."""
    import jax.numpy as jnp

    d, n_cond, hidden, rows = 32, 8, 64, FOLD_ROWS
    x, th = emulator_data(rows, d, n_cond, seed=12)
    data = df.DataArrays.make(x[:65536], th[:65536], rng=0)
    flow = df.Flow(perturb(jax, wide_chain(df, jax, d, n_cond, hidden,
                                           x[:4096], seed=2, joint=False)),
                   data)
    check(flow._kernel_fold(rows), "router did not pick the fold kernel")
    xq, thq = jnp.asarray(x), jnp.asarray(th)
    out = {"shapes": f"d={d} n={n_cond} h={hidden} 4 split blocks + norm, "
                     f"{rows} rows", "fold_router_picks_kernel": True}
    lp = flow.log_prob(xq, thq)
    thn = flow.prepare_theta(thq, (rows,))
    z, ldj = plain_fold(flow.model, xq, thn, "inv", True)
    # TF32 dots in the kernel against the float32 fold at highest
    out.update(parity("log_prob", lp, flow.base.log_prob(z) + ldj, 1e-2))
    key = jax.random.key(13)
    s = flow.sample((rows,), thq, key=key)
    s_ref = plain_fold(flow.model, flow.base.sample(key, (rows,)), thn,
                       "fwd", False)
    out.update(parity("sample", s, s_ref, 1e-2))
    return out


def phase_d128(df, jax, state):
    import jax.numpy as jnp

    d, n_cond, hidden, batch = 128, 8, 512, 4096
    x, th = emulator_data(D128_ROWS, d, n_cond, seed=6)
    data = df.DataArrays.make(x, th, rng=0)
    flow = df.Flow(wide_chain(df, jax, d, n_cond, hidden, x[:4096], seed=1),
                   data)
    df.train(flow, data, epochs=1, batchsize=batch, verbose=False,
             key=jax.random.key(7))
    train_nll = flow.train_loss[-1]
    check(np.isfinite(train_nll), f"non-finite d128 train loss {train_nll}")
    flow = df.Flow(perturb(jax, flow.model), data)
    g, per = 16, SWEEP_PER_THETA
    thetas = np.random.default_rng(8).uniform(size=(g, n_cond)).astype(
        np.float32)
    sw = flow.sample_sweep(thetas, per, key=jax.random.key(9))
    check(sw.shape == (g, per, d), f"sweep shape {sw.shape}")
    check(bool(jnp.isfinite(sw).all()), "non-finite sweep draws")
    pts = sw.reshape(g * per, d)
    th_rows = jnp.repeat(jnp.asarray(thetas), per, axis=0)
    lp = flow.log_prob(pts, th_rows)
    z, ldj = plain_fold(flow.model, pts, flow.prepare_theta(th_rows, (g * per,)),
                        "inv", True)
    lp_ref = flow.base.log_prob(z) + ldj
    out = {"shapes": f"d={d} n={n_cond} h={hidden} 4 joint blocks + norm, "
                     f"{x.shape[0]} rows, batch {batch}, 1 epoch; sweep "
                     f"{g} thetas x {per} draws",
           "train_nll": train_nll,
           "fold_router_picks_kernel": bool(flow._kernel_fold(g * per))}
    out.update(parity("sweep_log_prob", lp, lp_ref, 1e-2))
    return out


def phase_inference(df, jax, state):
    import jax.numpy as jnp

    flow = state["ref_flow"]
    n_p = SMC_PARTICLES
    theta_n = flow.prepare_theta((-1.0,), (n_p,))

    def log_p(x):
        z, ldj = flow.model.inverse(x, theta_n)
        return flow.base.log_prob(z) + ldj

    parts, logw, diag = df.run_smc(log_p, d=5, n_particles=n_p, n_steps=8,
                                   key=jax.random.key(10))
    check(bool(jnp.isfinite(logw).all()), "non-finite SMC log-weights")
    check(bool(jnp.isfinite(parts).all()), "non-finite SMC particles")
    ess = float(df.effective_sample_size(logw))

    # amortized posterior q(θ|x) with the trained flow as the simulator
    rng = np.random.default_rng(11)
    n_sim = POSTERIOR_PAIRS
    th_sim = rng.uniform(-1.0, 2.0, size=(n_sim, 1)).astype(np.float32)
    x_sim = np.asarray(flow.sample((n_sim,), jnp.asarray(th_sim),
                                   key=jax.random.key(12)))
    post = df.Flow(df.flow_chain(
        df.coupling_layer(1, [0], n=5, key=jax.random.key(13),
                          hidden_dim_s=32, hidden_dim_t=32),
        df.coupling_layer(1, [0], n=5, key=jax.random.key(14),
                          hidden_dim_s=32, hidden_dim_t=32),
    ), df.MetaData("", 1, 5, x_sim.min(0), x_sim.max(0)))
    df.fit_posterior(post, th_sim, x_sim, epochs=4, batchsize=512,
                     key=jax.random.key(15))
    v = np.asarray(post.valid_loss)
    check(np.isfinite(v).all() and v[-1] < v[0],
          f"posterior valid NLL did not fall: {v}")
    return {"shapes": f"SMC {n_p} particles x 8 steps over the d=5 flow; "
                      f"fit_posterior {n_sim} pairs, 4 epochs, batch 512",
            "smc_ess": ess, "posterior_valid_nll": v.tolist()}


def phase_streaming(df, jax, state):
    rows, d, n_cond, hidden, batch = STREAM_ROWS, 32, 8, 256, 8192
    os.makedirs(WORK, exist_ok=True)
    xp, tp = os.path.join(WORK, "x.f32"), os.path.join(WORK, "theta.f32")
    xm = np.memmap(xp, np.float32, "w+", shape=(rows, d))
    tm = np.memmap(tp, np.float32, "w+", shape=(rows, n_cond))
    step = min(rows, 1 << 19)
    for i in range(0, rows, step):
        xm[i:i + step], tm[i:i + step] = emulator_data(step, d, n_cond,
                                                       seed=20 + i // step)
    xm.flush(), tm.flush()
    del xm, tm
    x = np.memmap(xp, np.float32, "r", shape=(rows, d))
    th = np.memmap(tp, np.float32, "r", shape=(rows, n_cond))
    sample = df.DataArrays.make(np.asarray(x[:65536]),
                                np.asarray(th[:65536]), rng=0)
    flow = df.Flow(wide_chain(df, jax, d, n_cond, hidden, x[:4096]), sample)
    df.train_streaming(flow, x, th, epochs=1, batchsize=batch,
                       verbose=False, seed=1)
    t0 = time.perf_counter()  # a second epoch, compiled already
    df.train_streaming(flow, x, th, epochs=1, batchsize=batch,
                       verbose=False, seed=2)
    wall = time.perf_counter() - t0
    loss = flow.train_loss[-1]
    check(np.isfinite(loss), f"non-finite streaming loss {loss}")
    for p in (xp, tp):
        os.remove(p)
    return {"shapes": f"host memmap {rows} x {d + n_cond} float32 "
                      f"({rows * (d + n_cond) * 4 / 2**20:.0f} MiB), "
                      f"batch {batch}, d={d} h={hidden} 4 joint blocks",
            "train_nll": loss, "second_epoch_rows_per_s": rows / wall}


def phase_checkpoint(df, jax, state):
    import shutil

    flow = state["wide_flow"]
    path = os.path.join(WORK, "ckpt")
    shutil.rmtree(path, ignore_errors=True)
    x, th = emulator_data(8192, 32, 8, seed=30)
    before = np.asarray(flow.log_prob(x, th))
    df.save_flow(path, flow)
    loaded = df.load_flow(path)
    after = np.asarray(loaded.log_prob(x, th))
    shutil.rmtree(path, ignore_errors=True)
    check(np.array_equal(before, after), "log_prob changed across save/load")
    return {"shapes": "wide flow, 8192 rows", "log_prob_bit_equal": True,
            "devices": sorted({str(a.device) for a in
                               jax.tree_util.tree_leaves(loaded.model)})}


# -------------------------------------------------------------- four cards

def four_cards(df, jax, state):
    import jax.numpy as jnp
    from densityflows_tpu.inference import systematic_resample
    from densityflows_tpu.parallel.mesh import make_mesh
    from densityflows_tpu.parallel.resample import systematic_resample_sharded

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    mesh = make_mesh()
    d, n_cond, hidden, per_card = 32, 8, 256, 8192
    gbatch = per_card * 4

    def dp():
        x, th = emulator_data(DP_ROWS, d, n_cond, seed=3)
        data = df.DataArrays.make(x, th, rng=0)
        build = lambda: df.Flow(
            wide_chain(df, jax, d, n_cond, hidden, x[:4096]), data)
        one, four = build(), build()
        df.train(one, data, epochs=2, batchsize=gbatch, verbose=False,
                 key=jax.random.key(4))
        df.train(four, data, epochs=2, batchsize=gbatch, verbose=False,
                 key=jax.random.key(4), mesh=mesh)
        leaves = jax.tree_util.tree_leaves(four.model)
        devs = {dv for a in leaves for dv in a.sharding.device_set}
        check(len(devs) == 4, f"params live on {devs}")
        state["dp_flow"] = four
        out = {"shapes": f"d={d} h={hidden} 4 joint blocks, {x.shape[0]} "
                         f"rows, {per_card} rows per card x 4, 2 epochs",
               "history_one_card": one.train_loss,
               "history_four_cards": four.train_loss}
        # same batches; the gradient psum sums in another order and the
        # TF32 dots round differently per shard: over 64 Adam steps the
        # histories drift apart by ~1e-3 relative (7.8e-4 on four H100s)
        out.update(parity("dp_history", four.train_loss, one.train_loss,
                          5e-3))
        return out

    def sweep():
        flow = df.Flow(perturb(jax, state["dp_flow"].model),
                       state["dp_flow"].metadata)
        thetas = np.random.default_rng(8).uniform(size=(16, n_cond)).astype(
            np.float32)
        key = jax.random.key(9)
        s4 = flow.sample_sweep(thetas, SWEEP_PER_THETA, key=key, mesh=mesh)
        check(len(s4.sharding.device_set) == 4,
              f"sweep on {s4.sharding.device_set}")
        s1 = flow.sample_sweep(thetas, SWEEP_PER_THETA, key=key)
        out = {"shapes": f"16 thetas x {SWEEP_PER_THETA} draws, d=32 h=256"}
        out.update(parity("sweep_vs_one_card", s4, s1, 1e-2))
        return out

    def resample():
        n, dd = RESAMPLE_ROWS, 8
        rng = np.random.default_rng(10)
        lw_np = rng.normal(size=(n,)).astype(np.float32) * 3.0
        parts_np = rng.normal(size=(n, dd)).astype(np.float32)
        parts_np[:, 0] = np.arange(n)  # column 0 names each row's source
        lw, parts = jnp.asarray(lw_np), jnp.asarray(parts_np)
        key = jax.random.key(11)
        from densityflows_tpu.parallel.mesh import data_sharding

        lw4 = jax.device_put(lw, data_sharding(mesh, 1))
        p4 = jax.device_put(parts, data_sharding(mesh, 2))
        r4 = systematic_resample_sharded(lw4, p4, key, mesh)
        check(len(r4.sharding.device_set) == 4,
              f"resample on {r4.sharding.device_set}")
        r1 = parts[systematic_resample(lw, key)]
        # systematic resampling gives row i floor or ceil of n·w_i copies;
        # float32 prefix sums (summed in another order per shard) can move
        # a grid point across a CDF step of width ~1/n, so allow one more
        w = np.exp(lw_np.astype(np.float64) - lw_np.max())
        nw = n * w / w.sum()
        out = {"shapes": f"{n} particles x {dd}"}
        for tag, r in (("four_cards", r4), ("one_card", r1)):
            anc = np.asarray(r)[:, 0].astype(np.int64)
            dev = float(np.max(np.abs(np.bincount(anc, minlength=n) - nw)))
            check(dev < 2.0, f"{tag}: offspring count off by {dev}")
            out[f"{tag}_max_offspring_dev"] = dev
        out["max_offspring_dev_tol"] = 2.0
        out["rows_equal_share"] = float(np.mean(
            np.all(np.asarray(r4) == np.asarray(r1), -1)))
        return out

    run_phase("four_cards_train_dp", dp)
    run_phase("four_cards_sample_sweep", sweep)
    run_phase("four_cards_resample", resample)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel path on 4 local cards")
    args = ap.parse_args()

    import jax

    sys.path.insert(0, ROOT)
    from densityflows_tpu.utils.runtime import (
        enable_compile_cache, gpu_name_power_limit, require_gpu)

    enable_compile_cache(ROOT)
    dev = require_gpu()
    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "device_kind": dev.device_kind,
                      "jax": jax.__version__,
                      "nvidia_smi": gpu_name_power_limit()}), flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    import densityflows_tpu as df

    state = {}
    if args.four_cards:
        four_cards(df, jax, state)
    else:
        for name, fn in (("reference_5d", phase_reference),
                         ("wide_emulator", phase_wide),
                         ("fold_kernel", phase_fold_kernel),
                         ("d128", phase_d128),
                         ("inference", phase_inference),
                         ("streaming", phase_streaming),
                         ("checkpoint", phase_checkpoint)):
            run_phase(name, lambda fn=fn: fn(df, jax, state))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()) if args.four_cards else 1}}))


if __name__ == "__main__":
    main()
