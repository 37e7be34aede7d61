"""Executable documentation: every ```python block in docs/example.md and
docs/manual.md runs, in order, in a shared namespace per file.

The reference runs Documenter doctests (docs/make.jl:4-9) so its docs
cannot rot; this is the equivalent for our markdown docs. The snippets
execute against the REAL public API — every name, signature, and return
contract in the docs is exercised — with one controlled substitution:
work-budget kwargs (epochs, steps, particle counts, …) are clamped to
small values so the suite stays fast. A renamed function, changed
signature, or broken example fails this test.
"""

import functools
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import densityflows_tpu as df_real

_DOCS = os.path.join(os.path.dirname(__file__), os.pardir, "docs")

# per-function work-budget clamps: kwarg -> (cap, default_if_absent)
_BUDGETS = {
    "train": {"epochs": (3, 2)},
    "train_streaming": {"epochs": (2, 1), "batchsize": (64, None)},
    "train_ensemble": {"epochs": (3, 2), "n_members": (2, 2)},
    "fit_posterior": {"epochs": (3, 2)},
    "fit_posterior_rounds": {
        "n_rounds": (2, 2), "n_sims_per_round": (64, 64), "epochs": (2, 2),
    },
    "fit_variational": {"steps": (20, 20)},
    "run_smc": {"n_particles": (512, 512), "n_steps": (8, 8)},
    "flow_mcmc": {"n_steps": (12, 12), "n_chains": (16, 16)},
    "sbc_ranks": {"n_draws": (16, 16)},
    "StreamingLoader": {"batchsize": (64, None)},
    "sample_with_rejection": {},
}


class _BudgetedAPI:
    """Pass-through proxy over the package: expensive entry points get
    their work-budget kwargs clamped; everything else (classes, layer
    factories, cheap calls) is untouched."""

    def __getattr__(self, name):
        v = getattr(df_real, name)
        caps = _BUDGETS.get(name)
        if caps is None or not callable(v):
            return v

        @functools.wraps(v)
        def wrapped(*args, **kw):
            for k, (cap, dflt) in caps.items():
                if k in kw and isinstance(kw[k], int):
                    kw[k] = min(kw[k], cap)
                elif dflt is not None and k not in kw:
                    kw[k] = dflt
            if name == "flow_mcmc" and "burn_in" not in kw:
                kw["burn_in"] = kw.get("n_steps", 12) // 2
            return v(*args, **kw)

        return wrapped


def _blocks(md_name):
    with open(os.path.join(_DOCS, md_name)) as f:
        text = f.read()
    return re.findall(r"```python\n(.*?)```", text, re.S)


def _run_blocks(md_name, ns, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.environ.setdefault("MPLBACKEND", "Agg")
    blocks = _blocks(md_name)
    assert blocks, f"no python blocks found in {md_name}"
    for i, src in enumerate(blocks):
        try:
            exec(compile(src, f"{md_name}[block {i}]", "exec"), ns)
        except Exception as e:  # pragma: no cover - diagnostic
            raise AssertionError(
                f"{md_name} block {i} failed: {e}\n--- block ---\n{src}"
            ) from e


def test_example_md_runs(tmp_path, monkeypatch):
    ns = {"df": _BudgetedAPI()}
    # the example imports numpy/jax/df itself; 'df' is pre-bound so the
    # import statement rebinding it to the raw module is harmless for
    # names already wrapped — rebind after the first block instead
    _run_blocks_example(ns, tmp_path, monkeypatch)


def _run_blocks_example(ns, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.environ.setdefault("MPLBACKEND", "Agg")
    blocks = _blocks("example.md")
    for i, src in enumerate(blocks):
        src = src.replace("import densityflows_tpu as df",
                          "df = __budgeted_df__")
        ns["__budgeted_df__"] = _BudgetedAPI()
        try:
            exec(compile(src, f"example.md[block {i}]", "exec"), ns)
        except Exception as e:
            raise AssertionError(
                f"example.md block {i} failed: {e}\n--- block ---\n{src}"
            ) from e
    # the example's documented outputs hold at small budget
    assert np.asarray(ns["s"]).shape == (50_000, 5)
    assert np.asarray(ns["grid_lp"]).shape == (100, 100, 1, 1, 1)
    assert np.isfinite(ns["flow"].train_loss).all()


def test_manual_md_runs(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 5)).astype(np.float32)
    th_arr = rng.uniform(-1.0, 2.0, size=(512, 1)).astype(np.float32)
    data = df_real.DataArrays.make(x, th_arr, rng=0)
    key = jax.random.key(0)

    def make_chain(k):
        return df_real.flow_chain(
            df_real.coupling_block(5, [0, 1, 2], n=1, key=k,
                                   hidden_dim_s=8, hidden_dim_t=8),
            df_real.normalization_layer(x, -1.0, 1.0),
        )

    np.save(tmp_path / "big.npy",
            rng.normal(size=(256, 5)).astype(np.float32))
    xs = np.linspace(-2, 2, 5, dtype=np.float32)
    ns = {
        "df": _BudgetedAPI(),
        "np": np, "jax": jax, "jnp": jnp,
        "key": key, "x": x, "data": data,
        "theta": (-1.0,), "θ": (-1.0,),
        "make_chain": make_chain,
        "optimizer": optax.adam(1e-3),
        "x_val": x[:64], "th_val": th_arr[:64],
        "th_big": rng.uniform(-1, 2, size=(256, 1)).astype(np.float32),
        "xs1": xs, "xs2": xs, "xs3": xs, "xs4": xs, "xs5": xs,
        "log_density": lambda v: -0.5 * jnp.sum(v * v, axis=-1),
        "theta_sims": rng.normal(size=(256, 5)).astype(np.float32),
        "x_sims": rng.normal(size=(256, 1)).astype(np.float32),
        "simulator": lambda th: (
            th[:, :1] + 0.1
            * np.random.default_rng(1).normal(size=(len(th), 1))
        ).astype(np.float32),
        "prior_sample": lambda r, k: r.normal(size=(k, 5)).astype(np.float32),
        "prior_log_prob": lambda th: -0.5 * np.sum(
            np.asarray(th, np.float64) ** 2, axis=-1),
        "x_obs": np.full((1, 1), 0.3, np.float32),
        "theta_true": rng.normal(size=(1, 5)).astype(np.float32),
    }
    _run_blocks("manual.md", ns, tmp_path, monkeypatch)
    # documented contracts hold
    assert np.asarray(ns["lp_k"]).shape[0] == 2  # K members
    assert np.asarray(ns["samples"]).shape[-1] == 5
    assert np.isfinite(float(ns["ks"]))


def test_api_reference_is_fresh():
    """docs/api.md must match what tools/render_api.py generates from the
    live public surface — a renamed/added export without a doc refresh
    fails here."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "render_api",
        os.path.join(os.path.dirname(_DOCS), "tools", "render_api.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(os.path.dirname(_DOCS), "docs", "api.md")) as f:
        committed = f.read()
    assert committed == mod.render(), (
        "docs/api.md is stale — run: python tools/render_api.py"
    )
