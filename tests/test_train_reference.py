"""``train()`` / ``train_streaming()`` against a plain step-loop reference.

The reference is written here, independent of the code under test: a
Python loop of single jitted steps — ``jax.grad`` of the masked NLL at
``jax.default_matmul_precision("highest")`` and Adam written out by hand
— over the same shuffle keys and batch composition that ``train``'s
single program uses (``jax.random.split(key, epochs)`` per-epoch keys,
``jax.random.permutation`` order, final partial batch masked). The bar is
float32 accumulation-order noise, not a statistical tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import densityflows_tpu as df
from densityflows_tpu.models.layers import NICECouplingLayer

ATOL = 1e-4
BS = 32


# ---------------------------------------------------------------- reference

def _nll(model, base, x, th, m):
    z, ldj = model.inverse(x, th)
    per = base.log_prob(z) + ldj
    return -jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1e-12)


@jax.jit
def _grad_step(model, base, x, th, m):
    with jax.default_matmul_precision("highest"):
        return jax.value_and_grad(_nll)(model, base, x, th, m)


@jax.jit
def _eval(model, base, x, th, m):
    with jax.default_matmul_precision("highest"):
        return _nll(model, base, x, th, m)


class _Adam:
    """Adam by hand: t += 1; m, v moments; bias-corrected step."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        zeros = lambda p: jax.tree_util.tree_map(jnp.zeros_like, p)
        self.m, self.v, self.t = zeros(params), zeros(params), 0

    def step(self, params, g):
        self.t += 1
        tm = jax.tree_util.tree_map
        self.m = tm(lambda m, g: self.b1 * m + (1 - self.b1) * g, self.m, g)
        self.v = tm(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                    self.v, g)
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        return tm(lambda p, m, v: p - self.lr * (m / c1)
                  / (jnp.sqrt(v / c2) + self.eps), params, self.m, self.v)


def _finite(loss, g):
    return bool(np.isfinite(float(loss)) and all(
        np.all(np.isfinite(np.asarray(a)))
        for a in jax.tree_util.tree_leaves(g)))


def _reference(flow, data, *, epochs, key, adam, weights=None,
               guard=False, track_best=False):
    """Returns (train_hist, valid_hist, model, best_model, skips)."""
    md = flow.metadata
    x, th = (jnp.asarray(a) for a in data.normalized_training_data(md))
    xv, thv = (jnp.asarray(a) for a in data.normalized_validation_data(md))
    n = x.shape[0]
    w = wv = None
    if weights is not None:
        w = jnp.asarray(weights[np.asarray(data.partition.training)])
        wv = jnp.asarray(weights[np.asarray(data.partition.validation)])
    n_b = -(-n // BS)
    model, base = flow.model, flow.base
    best, best_vl = None, np.inf
    tls, vls, skips = [], [], []
    for ekey in jax.random.split(key, epochs):
        perm = np.asarray(jax.random.permutation(ekey, n))
        idx = np.zeros(n_b * BS, np.int64)
        idx[:n] = perm
        skipped = 0
        for b in range(n_b):
            i = idx[b * BS:(b + 1) * BS]
            m = (np.arange(b * BS, (b + 1) * BS) < n).astype(np.float32)
            m = jnp.asarray(m) * (w[i] if w is not None else 1.0)
            loss, g = _grad_step(model, base, x[i], th[i], m)
            if guard and not _finite(loss, g):
                skipped += 1
                continue
            model = adam.step(model, g)
        ones = lambda k, ww: jnp.ones(k) if ww is None else ww
        tls.append(float(_eval(model, base, x, th, ones(n, w))))
        vl = float(_eval(model, base, xv, thv, ones(xv.shape[0], wv)))
        vls.append(vl)
        skips.append(skipped)
        if track_best and vl < best_vl:
            best, best_vl = model, vl
    return tls, vls, model, best, skips


def _close_models(a, b, atol=ATOL):
    for u, v in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        if u.size:
            np.testing.assert_allclose(np.asarray(u), np.asarray(v),
                                       atol=atol)


# -------------------------------------------------------------- fixtures

def _cond_data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(137, 5)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(137, 1)).astype(np.float32)
    return df.DataArrays.make(x, th, rng=0), x


def _ks(n=4):
    return jax.random.split(jax.random.key(0), n)


def _chain(kind, d, x):
    ks = _ks()
    cl = df.coupling_layer
    norm = lambda: df.normalization_layer(x, -1.0, 1.0)
    h16 = dict(hidden_dim_s=16, hidden_dim_t=16)
    h12 = dict(hidden_dim_s=12, hidden_dim_t=12)
    if kind == "reference":
        return df.flow_chain(cl(d, [0, 1, 2], key=ks[0], **h16),
                             cl(d, [2, 3, 4], key=ks[1], **h16),
                             cl(d, [4, 0, 1], key=ks[2], **h16), norm())
    if kind == "nice":
        return df.flow_chain(
            cl(d, [0, 1, 2], kind=NICECouplingLayer, key=ks[0]),
            cl(d, [2, 3, 4], kind=NICECouplingLayer, key=ks[1]), norm())
    if kind == "joint":
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], joint_conditioner=True,
               hidden_dim_s=24, hidden_dim_t=24),
            cl(d, [2, 3, 4], key=ks[1], joint_conditioner=True,
               hidden_dim_s=24, hidden_dim_t=24), norm())
    if kind == "nobias_tanh":
        return df.flow_chain(
            df.coupling_block(d.num_dimensions, [0, 2, 4], n=1, key=ks[0],
                              activation_s="tanh", activation_t="tanh",
                              bias=False, hidden_dim_s=8, hidden_dim_t=8),
            norm())
    if kind == "no_norm":
        return df.flow_chain(cl(d, [0, 1, 2], key=ks[0], **h16),
                             cl(d, [2, 3, 4], key=ks[1], **h16))
    if kind == "deep":
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], n_sublayers_s=3, n_sublayers_t=3,
               hidden_dim_s=12, hidden_dim_t=12), norm())
    if kind == "clamped":
        # a LOW clamp so the tanh's nonlinear region is exercised
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], max_log_scale=0.1, **h16),
            cl(d, [2, 3, 4], key=ks[1], max_log_scale=0.5, **h16), norm())
    if kind == "clamped_joint":
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], joint_conditioner=True,
               hidden_dim_s=24, hidden_dim_t=24, max_log_scale=0.2),
            norm())
    if kind == "permutation":
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], **h12),
            df.permutation_layer([4, 2, 0, 3, 1]),
            cl(d, [0, 1, 2], key=ks[1], **h12),
            df.permutation_layer([2, 0, 1, 4, 3]), norm())
    if kind == "actnorm":
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], **h12), df.actnorm_layer(x),
            cl(d, [2, 3, 4], key=ks[1], **h12), norm())
    if kind == "composite":
        return df.flow_chain(
            cl(d, [0, 1, 2], key=ks[0], max_log_scale=0.3, **h12),
            df.permutation_layer([3, 1, 4, 0, 2]), df.actnorm_layer(x),
            cl(d, [1, 2, 3], key=ks[1], joint_conditioner=True,
               max_log_scale=0.4, **h12), norm())
    raise KeyError(kind)


CHAIN_CASES = ["reference", "nice", "joint", "nobias_tanh", "no_norm",
               "deep", "clamped", "clamped_joint", "permutation", "actnorm"]
CASES = CHAIN_CASES + [
    "unconditional", "weighted", "skip_nonfinite_exploding",
    "skip_nonfinite_healthy", "track_best", "tagged_adam", "composite",
    "chunked_continuation", "resume_continuation", "metrics_log",
    "mesh_dp", "streaming", "streaming_mesh", "streaming_valid_metrics",
]


def _poisoned_data():
    """NaN rows poison exactly the batches that gather them."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(96, 3)).astype(np.float32)
    x[[7, 41]] = np.nan
    return df.DataArrays.make(x, rng=0), np.nan_to_num(x)


def _resident_case(case, tmp_path):
    key = jax.random.key(3)
    epochs = 3
    kw, adam_kw, ref_kw = {}, {}, {}
    if case == "unconditional":
        rng = np.random.default_rng(4)
        x = rng.normal(size=(90, 4)).astype(np.float32)
        data = df.DataArrays.make(x, rng=0)
        build = lambda: df.flow_chain(
            df.coupling_layer(data, [0, 1], key=_ks()[0], hidden_dim_s=8,
                              hidden_dim_t=8),
            df.normalization_layer(x, -1.0, 1.0))
    elif case.startswith("skip_nonfinite"):
        if case.endswith("exploding"):
            data, xc = _poisoned_data()
        else:
            rng = np.random.default_rng(5)
            xc = rng.normal(size=(96, 3)).astype(np.float32)
            data = df.DataArrays.make(xc, rng=0)
        build = lambda: df.flow_chain(
            df.coupling_layer(data, [0, 1], key=_ks()[0], hidden_dim_s=8,
                              hidden_dim_t=8),
            df.normalization_layer(xc, -1.0, 1.0))
        kw["skip_nonfinite"] = True
        ref_kw["guard"] = True
    else:
        data, x = _cond_data()
        kind = case if case in CHAIN_CASES or case == "composite" \
            else "reference"
        build = lambda: _chain(kind, data, x)
    if case in ("weighted", "composite"):
        w = np.random.default_rng(7).uniform(
            0.2, 3.0, size=data.x.shape[0]).astype(np.float32)
        kw["weights"] = w
        ref_kw["weights"] = w
    if case == "tagged_adam":
        adam_kw = dict(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6)
        kw["optimizer"] = df.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6)
    return data, build, epochs, key, kw, adam_kw, ref_kw


@pytest.mark.parametrize("case", CASES)
def test_train_matches_step_loop_reference(case, tmp_path):
    if case.startswith("streaming"):
        return _streaming_case(case)
    data, build, epochs, key, kw, adam_kw, ref_kw = _resident_case(
        case, tmp_path)
    flow, ref_flow = df.Flow(build(), data), df.Flow(build(), data)
    adam = _Adam(ref_flow.model, **adam_kw)
    optimizer = kw.pop("optimizer", None)

    if case == "track_best":
        # one early-stopping chunk covering every epoch: no stop, and the
        # restore picks the exact best-validation epoch
        df.train(flow, data, optimizer, epochs=epochs, batchsize=BS,
                 verbose=False, key=key, early_stopping_patience=100,
                 early_stopping_check_every=epochs, restore_best=True)
        tls, vls, _, best, _ = _reference(
            ref_flow, data, epochs=epochs, key=jax.random.fold_in(key, 0),
            adam=adam, track_best=True)
        np.testing.assert_allclose(flow.valid_loss, vls, atol=ATOL)
        _close_models(flow.model, best)
        return
    if case in ("chunked_continuation", "resume_continuation"):
        ckpt = str(tmp_path / "ckpt")
        if case == "chunked_continuation":
            df.train(flow, data, epochs=4, batchsize=BS, verbose=False,
                     key=key, checkpoint_dir=ckpt, checkpoint_every=2)
        else:
            df.train(flow, data, epochs=2, batchsize=BS, verbose=False,
                     key=key, checkpoint_dir=ckpt, checkpoint_every=2)
            flow = df.Flow(build(), data)  # a fresh process's flow
            df.train(flow, data, epochs=4, batchsize=BS, verbose=False,
                     key=key, checkpoint_dir=ckpt, checkpoint_every=2,
                     resume=True)
        hist_t, hist_v = [], []
        for done in (0, 2):  # chunk keys derive from the epoch position
            tls, vls, model, _, _ = _reference(
                ref_flow, data, epochs=2, key=jax.random.fold_in(key, done),
                adam=adam)
            ref_flow.model = model
            hist_t += tls
            hist_v += vls
        np.testing.assert_allclose(flow.train_loss, hist_t, atol=ATOL)
        np.testing.assert_allclose(flow.valid_loss, hist_v, atol=ATOL)
        _close_models(flow.model, ref_flow.model)
        return

    mesh = None
    if case == "mesh_dp":
        from densityflows_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
        assert mesh.shape["data"] == 8
    log = str(tmp_path / "metrics.jsonl") if case == "metrics_log" else None
    df.train(flow, data, optimizer, epochs=epochs, batchsize=BS,
             verbose=False, key=key, mesh=mesh, metrics_log=log, **kw)
    tls, vls, model, _, skips = _reference(
        ref_flow, data, epochs=epochs, key=key, adam=adam, **ref_kw)
    if case == "skip_nonfinite_exploding":
        assert sum(flow.skipped_updates) > 0
        # full-split evals include the NaN rows: NaN histories on both
        assert np.isnan(flow.train_loss).all() and np.isnan(tls).all()
    else:
        np.testing.assert_allclose(flow.train_loss, tls, atol=ATOL)
        np.testing.assert_allclose(flow.valid_loss, vls, atol=ATOL)
    if "skip_nonfinite" in kw:
        assert flow.skipped_updates == skips
    _close_models(flow.model, model)
    if log is not None:
        rows = [json.loads(line) for line in open(log)]
        assert [r["epoch"] for r in rows] == [1, 2, 3]
        np.testing.assert_allclose([r["train_nll"] for r in rows], tls,
                                   atol=ATOL)
        np.testing.assert_allclose([r["valid_nll"] for r in rows], vls,
                                   atol=ATOL)


def _streaming_case(case):
    """``train_streaming`` (unshuffled, so the reference's batch order is
    simply the row order): per-epoch train NLL = mask-weighted mean of
    the batch losses, parameters after every step, and — with
    ``valid_data`` — the per-epoch validation NLL."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(150, 4)).astype(np.float32)
    th = rng.uniform(0, 1, size=(150, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    build = lambda: df.flow_chain(
        df.coupling_block(data, None, key=_ks()[0], hidden_dim_s=16,
                          hidden_dim_t=16),
        df.normalization_layer(x, -1.0, 1.0))
    flow, ref = df.Flow(build(), data), df.Flow(build(), data)
    mesh = None
    if case == "streaming_mesh":
        from densityflows_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    valid = (x[:40], th[:40]) if case == "streaming_valid_metrics" else None
    df.train_streaming(flow, x, th, epochs=2, batchsize=BS, shuffle=False,
                       verbose=False, mesh=mesh, valid_data=valid)

    md = ref.metadata
    thn = jnp.asarray(df.normalize_input(th, md.theta_min, md.theta_max))
    adam, model = _Adam(ref.model), ref.model
    n, n_b = x.shape[0], -(-x.shape[0] // BS)
    for e in range(2):
        losses, ws = [], []
        for b in range(n_b):
            i = np.minimum(np.arange(b * BS, (b + 1) * BS), n - 1)
            m = (np.arange(b * BS, (b + 1) * BS) < n).astype(np.float32)
            loss, g = _grad_step(model, ref.base, jnp.asarray(x[i]), thn[i],
                                 jnp.asarray(m))
            model = adam.step(model, g)
            losses.append(float(loss))
            ws.append(m.sum())
        np.testing.assert_allclose(flow.train_loss[e],
                                   np.dot(losses, ws) / np.sum(ws),
                                   atol=ATOL)
        if valid is not None:
            vl = float(_eval(model, ref.base, jnp.asarray(x[:40]), thn[:40],
                             jnp.ones(40)))
            np.testing.assert_allclose(flow.valid_loss[e], vl, atol=ATOL)
    _close_models(flow.model, model)
