"""Whole-chain fold kernel for the GPU (Pallas, Triton route).

One ``pallas_call`` folds a row tile through EVERY flow layer: each block
loads a (TB, D) batch tile and its (TB, N) θ tile once, runs every
conditioner MLP with the tile's activations held in registers, applies
the affine/ldj epilogues, and writes the result once. Weights are read
from global memory; they total a few MB and stay in the 50 MB L2. The
saving over XLA's per-layer fold is the inter-layer activation traffic:
at d=32, h=256 and 2¹⁸ rows each conditioner layer's f32 activations are
256 MB, so the straight fold round-trips them through device memory once
per dense layer.

This module is layer-agnostic: it executes a *plan* — a static tuple of
op descriptors — against a flat tuple of parameter arrays, built from a
``FlowChain`` by ``models/fused_chain.py``. Every parameter arrives
padded to the kernel's shapes: the feature width to ``D`` and the θ
width to ``N`` (powers of two ≥ 16, the smallest dot operand Triton
takes), hidden widths to ``H`` (a power of two ≥ 16). Zero padding is
exact: padded hidden units meet zero rows of the next weight, padded
feature columns get zero ``s``/``t`` and stay zero.

Op codes (``plan`` entries):

- ``("couplings", count, ("coupling", kind, dirn, n_s, n_t, act_s, act_t,
  bias_s, bias_t, has_th, has_id, clamp))`` — a run of ``count`` affine
  couplings (kind ``"nvp"``/``"nice"``/``"joint"``) with one signature,
  each parameter stacked along a leading ``count`` axis; the kernel loops
  over the run, so its code is compiled once however deep the chain. The
  feature split/recombine of the jnp path
  (``ops/coupling.py``) is folded into the conditioner weights outside
  the kernel: the first dense layer is pre-split into a θ part (N, H) and
  a zero-padded x part (D, H); the last dense layer scatters into D-wide
  ``s``/``t`` that are exactly zero on identity dims, so the transform is
  the elementwise ``y = x·exp(s) + t``. Params per net: first-layer
  weights (1 or 2), hidden weights (n_layers−2), final weight, then one
  bias per dense layer when present. ``"joint"`` runs one shared stack
  into two folded heads: first-layer blocks, n_layers−2 hidden weights,
  s head, t head, then n_layers−1 stack biases + 2 head biases.
- ``("affine",)`` — elementwise ``x·a + b``. Params: ``a``, ``b`` (1, D).
- ``("linear",)`` — ``x @ A``. Params: ``A`` (D, D). Runs at IEEE f32
  (permutations must stay exact).
- ``("logit", dirn, eps)`` — smooth box bijection. Params: ``lo``,
  ``hi``, ``wlog`` = log(hi−lo), each (1, D); only for unpadded D.

Constant log-determinants (normalization, actnorm, linear layers) are
summed outside the kernel by the caller.

Precision: conditioner dots take f32 operands at ``Precision.DEFAULT``,
which Triton runs as TF32 with f32 accumulation — the same arithmetic
XLA's GPU backend uses for an f32 matmul at default precision. The hidden
dimension is tiled into ``C``-wide column chunks: the last hidden layer
of each conditioner runs one chunk per loop step straight into the
output layer, so no block ever holds a whole (H, H) weight.

Gradients: the caller wraps this in a ``jax.custom_vjp`` whose backward
runs the plain jnp fold (models/fused_chain.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["run_chain", "op_param_count", "tile_shape", "pow2_width"]


def pow2_width(w: int) -> int:
    """Smallest power of two ≥ max(w, 16): Triton blocks are powers of
    two, and a dot operand needs every dimension ≥ 16."""
    return max(16, 1 << max(0, int(w) - 1).bit_length())


def tile_shape(hidden: int) -> tuple[int, int, int, int]:
    """(rows per block, hidden chunk width, warps, pipeline stages) for a
    padded hidden width: the best of the tiles tried on the H100 (PERF.md,
    "Kernel decisions"). At hidden ≥ 256 wider chunks or more stages
    overflow the block's 227 KB of shared memory."""
    if hidden <= 128:
        return 128, hidden, 4, 1
    if hidden <= 256:
        return 128, 64, 8, 2
    return 32, 64, 4, 1


def _act(name, u):
    if name == "identity":
        return u
    if name == "relu":
        return jnp.maximum(u, 0.0)
    if name == "tanh":
        return jnp.tanh(u)
    if name == "sigmoid":
        return jax.nn.sigmoid(u)
    if name == "silu":
        return u * jax.nn.sigmoid(u)
    if name == "gelu":
        c = 0.7978845608028654
        return 0.5 * u * (1.0 + jnp.tanh(c * (u + 0.044715 * u * u * u)))
    if name == "softplus":
        return jax.nn.softplus(u)
    if name == "elu":
        return jnp.where(u > 0, u, jnp.expm1(u))
    if name == "leaky_relu":
        return jnp.where(u >= 0, u, 0.01 * u)
    raise ValueError(f"unsupported activation for fused chain: {name}")


def coupling_param_count(op) -> int:
    (_, kind, _, n_s, n_t, _, _, bias_s, bias_t, has_th, has_id,
     _clamp) = op
    first = (1 if has_th else 0) + (1 if has_id else 0)
    if kind == "joint":
        return first + n_s + ((n_s + 1) if bias_s else 0)

    def net(n_layers, has_bias):
        return first + n_layers - 1 + (n_layers if has_bias else 0)

    c = net(n_t, bias_t)
    if kind == "nvp":
        c += net(n_s, bias_s)
    return c


def op_param_count(op) -> int:
    tag = op[0]
    if tag == "couplings":
        return coupling_param_count(op[2])
    if tag == "affine":
        return 2
    if tag == "linear":
        return 1
    if tag == "logit":
        return 3
    raise ValueError(f"unknown chain op {tag!r}")


class _Layer:
    """View of one layer ``l`` (static or traced) of a stacked
    (count, r, c) parameter ref: indexes like an (r, c) ref."""

    def __init__(self, ref, l):
        self.ref, self.l = ref, l

    @property
    def shape(self):
        return self.ref.shape[1:]

    def __getitem__(self, idx):
        if idx is Ellipsis:
            idx = (slice(None), slice(None))
        return self.ref[(self.l,) + tuple(idx)]


def _dot(a, w):
    # TF32 operands, f32 accumulation (see module docstring)
    return jax.lax.dot(a, w.astype(jnp.float32),
                       precision=jax.lax.Precision.DEFAULT,
                       preferred_element_type=jnp.float32)


def _cols(ref, j, c):
    return ref[:, pl.ds(j * c, c)]


def _first_chunk(x, th, w_refs, b_ref, j, c):
    """Hidden chunk ``j`` of the input layer: θ@W1θ[:, j] + x@W1x[:, j]."""
    u = None
    for inp, w in zip((th, x), w_refs):
        if inp is None or w is None:
            continue
        t = _dot(inp, _cols(w, j, c))
        u = t if u is None else u + t
    if b_ref is not None:
        u = u + _cols(b_ref, j, c).astype(jnp.float32)
    return u


def _hidden_chunk(a, w_ref, b_ref, j, c):
    """Output chunk ``j`` of a dense layer over input chunks ``a``:
    Σ_k a_k @ W[k, j] (+ b_j)."""
    u = None
    for k, ak in enumerate(a):
        t = _dot(ak, w_ref[pl.ds(k * c, c), pl.ds(j * c, c)])
        u = t if u is None else u + t
    if b_ref is not None:
        u = u + _cols(b_ref, j, c).astype(jnp.float32)
    return u


def _mlp(x, th, ws, bs, act, n_layers, has_th, has_id, c, heads=1):
    """Folded conditioner. ``ws``: first-layer blocks, hidden weights,
    ``heads`` output weights; ``bs``: one bias per layer (+ extra heads)
    or empty. Returns a list of ``heads`` D-wide outputs.

    Every layer but the last hidden one is kept as a static list of
    (TB, C) chunks; the last hidden layer runs chunk by chunk in a loop
    that feeds each chunk straight into the output layer, so a block
    never holds a whole (H, H) weight and the loop body is compiled once.
    """
    n_first = (1 if has_th else 0) + (1 if has_id else 0)
    first = list(ws[:n_first])
    w_first = (first.pop(0) if has_th else None,
               first.pop(0) if has_id else None)
    hidden = ws[n_first:len(ws) - heads]
    outs = ws[len(ws) - heads:]
    b = (lambda i: bs[i]) if bs else (lambda i: None)
    n_chunks = outs[0].shape[0] // c
    if hidden:
        a = [_act(act, _first_chunk(x, th, w_first, b(0), j, c))
             for j in range(n_chunks)]
        for i, w in enumerate(hidden[:-1]):
            a = [_act(act, _hidden_chunk(a, w, b(i + 1), j, c))
                 for j in range(n_chunks)]
        last = lambda j: _hidden_chunk(a, hidden[-1], b(len(hidden)), j, c)
    else:
        last = lambda j: _first_chunk(x, th, w_first, b(0), j, c)

    def body(j, acc):
        u = _act(act, last(j))
        return tuple(o + _dot(u, w[pl.ds(j * c, c), :])
                     for o, w in zip(acc, outs))

    zero = jnp.zeros((x.shape[0], outs[0].shape[1]), jnp.float32)
    acc = jax.lax.fori_loop(0, n_chunks, body, (zero,) * heads)
    return [o if b(n_layers - 1 + h) is None
            else o + b(n_layers - 1 + h)[...].astype(jnp.float32)
            for h, o in enumerate(acc)]


def _apply_coupling(op, prefs, x, th, ldj, c):
    (_, kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t,
     has_th, has_id, clamp) = op
    n_first = (1 if has_th else 0) + (1 if has_id else 0)
    if kind == "joint":
        n_w = n_first + n_s
        s, t = _mlp(x, th, prefs[:n_w], prefs[n_w:] if bias_s else (),
                    act_s, n_s, has_th, has_id, c, heads=2)
    else:
        k = 0
        s = None
        if kind == "nvp":
            n_w = n_first + n_s - 1
            n_b = n_s if bias_s else 0
            s, = _mlp(x, th, prefs[:n_w], prefs[n_w:n_w + n_b], act_s,
                      n_s, has_th, has_id, c)
            k = n_w + n_b
        n_w = n_first + n_t - 1
        t, = _mlp(x, th, prefs[k:k + n_w],
                  prefs[k + n_w:] if bias_t else (), act_t, n_t,
                  has_th, has_id, c)
    # s/t are exactly 0 on identity and padded dims (folded scatter), so
    # the full-width transform IS the coupling (RNVP.jl:77-96, 168-187)
    if s is None:  # NICE (NICE.jl:63-81)
        return (x + t if dirn == "fwd" else x - t), ldj
    if clamp:
        s = clamp * jnp.tanh(s / clamp)
    if dirn == "fwd":
        x = x * jnp.exp(s) + t
        if ldj is not None:
            ldj = ldj + jnp.sum(s, axis=-1)
    else:
        x = (x - t) * jnp.exp(-s)
        if ldj is not None:
            ldj = ldj - jnp.sum(s, axis=-1)
    return x, ldj


def _apply_couplings(op, prefs, x, th, ldj, c):
    """A run of ``count`` couplings with one signature, params stacked
    along a leading axis: a loop over layers, compiled once."""
    _, count, cop = op
    if count == 1:
        return _apply_coupling(cop, [_Layer(r, 0) for r in prefs], x, th,
                               ldj, c)

    def body(l, carry):
        xx, lj = carry
        return _apply_coupling(cop, [_Layer(r, l) for r in prefs], xx, th,
                               lj, c)

    return jax.lax.fori_loop(0, count, body, (x, ldj))


def _apply_logit(op, prefs, x, ldj):
    _, dirn, eps = op
    lo = prefs[0][...].astype(jnp.float32)
    hi = prefs[1][...].astype(jnp.float32)
    wlog = prefs[2][...].astype(jnp.float32)
    if dirn == "fwd":  # z → x = lo + (hi−lo)·σ(z)
        z = x
        x = lo + (hi - lo) * jax.nn.sigmoid(z)
    else:  # x → z = logit((x−lo)/(hi−lo)), clamped
        u = jnp.clip((x - lo) / (hi - lo), eps, 1.0 - eps)
        z = jnp.log(u) - jnp.log1p(-u)
        x = z
    if ldj is not None:
        row = jnp.sum(-jax.nn.softplus(-z) - jax.nn.softplus(z) + wlog,
                      axis=-1)
        ldj = ldj + row if dirn == "fwd" else ldj - row
    return x, ldj


def _chain_kernel(plan, has_theta, with_ldj, c, *refs):
    i = 0
    x_ref = refs[i]; i += 1
    th_ref = None
    if has_theta:
        th_ref = refs[i]; i += 1
    x = x_ref[...].astype(jnp.float32)
    th = th_ref[...].astype(jnp.float32) if th_ref is not None else None
    ldj = jnp.zeros((x.shape[0],), jnp.float32) if with_ldj else None
    for op in plan:
        n_p = op_param_count(op)
        prefs = refs[i:i + n_p]
        i += n_p
        tag = op[0]
        if tag == "couplings":
            x, ldj = _apply_couplings(op, prefs, x, th, ldj, c)
        elif tag == "affine":
            x = (x * prefs[0][...].astype(jnp.float32)
                 + prefs[1][...].astype(jnp.float32))
        elif tag == "linear":
            x = jax.lax.dot(x, prefs[0][...].astype(jnp.float32),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
        else:
            x, ldj = _apply_logit(op, prefs, x, ldj)
    out_ref = refs[i]
    out_ref[...] = x.astype(out_ref.dtype)
    if with_ldj:
        refs[i + 1][...] = ldj


@functools.partial(
    jax.jit,
    static_argnames=("plan", "with_ldj", "hidden", "interpret"))
def _run(x, theta, flat_params, *, plan, with_ldj, hidden, interpret):
    rows, d = x.shape
    tb, c, warps, stages = tile_shape(hidden)
    row = lambda w: pl.BlockSpec((tb, w), lambda i: (i, 0))
    whole = lambda p: pl.BlockSpec(p.shape, lambda i: (0,) * p.ndim)
    in_specs, args = [row(d)], [x]
    if theta is not None:
        in_specs.append(row(theta.shape[-1]))
        args.append(theta)
    in_specs += [whole(p) for p in flat_params]
    args += list(flat_params)
    out_shape = [jax.ShapeDtypeStruct((rows, d), x.dtype)]
    out_specs = [row(d)]
    if with_ldj:
        out_shape.append(jax.ShapeDtypeStruct((rows,), jnp.float32))
        out_specs.append(pl.BlockSpec((tb,), lambda i: (i,)))
    kernel = functools.partial(_chain_kernel, plan, theta is not None,
                               with_ldj, c)
    return pl.pallas_call(
        kernel,
        grid=(rows // tb,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps,
                                             num_stages=stages),
        interpret=interpret,
        name="flow_chain_fold",
    )(*args)


def run_chain(plan, flat_params, x, theta, *, with_ldj, hidden,
              interpret=False):
    """Execute a padded chain plan over rows.

    ``x``: (B, D); ``theta``: (B, N) or None; ``hidden``: the padded
    hidden width every conditioner shares. Rows are zero-padded to a tile
    multiple and sliced back (padded rows flow through every op without
    NaNs). Returns ``(y, ldj)`` with ldj (B,) f32 — without the constant
    per-layer terms — or just ``y``. ``interpret=True`` runs the Pallas
    interpreter (CPU tests); otherwise the kernel compiles for the GPU.
    """
    rows = x.shape[0]
    tb = tile_shape(hidden)[0]
    pad = (-rows) % tb
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        if theta is not None:
            theta = jnp.pad(theta, ((0, pad), (0, 0)))
    y, *ldj = _run(x, theta, tuple(flat_params), plan=plan,
                   with_ldj=with_ldj, hidden=hidden, interpret=interpret)
    y = y[:rows]
    return (y, ldj[0][:rows]) if with_ldj else y
