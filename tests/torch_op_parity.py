"""Helpers of the operator-layer parity tests (``tests/test_torch_
{elemwise,reduce_matrix,ordering_sample,spatial}.py``): one case of
``chip_smoke.op_sweep_cases`` run through the JAX package's op
(``registry.invoke`` forward, ``jax.vjp`` of its compute backward) and
the port's (``registry.invoke`` on CPU tensors, ``torch.autograd``), on
the same numpy inputs and cotangents.

Tolerances, stated once: fp32 forwards rtol = atol = 1e-5 (exact
arithmetic and the cases marked ``exact``, whose results are integers,
indices or 0/1: equal); gradients rtol = 1e-5 and atol = 1e-5 times
max(1, max |JAX gradient|), ``chip_smoke.py``'s scale (a gradient that
sums many terms, as a ``SpatialTransformer`` parameter's over its whole
grid, cancels to values far below the terms'); bf16 within 2
units of bf16 (U = 2^-8) of max(1, |JAX|), gradients within 4 U: the
JAX derivative rounds each of its intermediates to bf16 (``hypot``'s
x / hypot, ``erf``'s exp), where torch's bf16 kernels compute in
float32 and round once.  Dtypes equal.  Shapes are the
chip's sweep's, cut down (``SMALL``), so each case runs in milliseconds.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch  # noqa: F401  (registers the port's ops)
from mxnet_tpu_torch.ndarray import dtype_name
from mxnet_tpu_torch.ops import registry as treg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (op_sweep_cases, sweep_tensors)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-5, atol=1e-5)
BF16_UNITS, BF16_GRAD_UNITS = 2.0 ** -7, 2.0 ** -6
SMALL = dict(n=6, m=16, attn=(2, 16, 8))


def cases(*families):
    """The sweep's cases of ``families`` at ``SMALL`` shapes, with a test
    id each (its name and position)."""
    all_cases = chip_smoke.op_sweep_cases(np.random.RandomState(20), **SMALL)
    picked = [c for c in all_cases if c["family"] in families]
    return picked, [f"{i}-{c['name']}" for i, c in enumerate(picked)]


def jax_run(case, bf16=False):
    """(outputs, gradients at ``grads``, the output cotangents) of the
    JAX op, as numpy (bf16 read back as float32, dtype names kept)."""
    ins = [jnp.asarray(a, jnp.bfloat16) if bf16 and a.dtype == np.float32
           else jnp.asarray(a) for a in case["ins"]]
    outs, _ = jreg.invoke(case["name"], ins, case["attrs"], is_train=True)
    cots = [np.random.RandomState(1 + j).randn(*o.shape).astype(np.float32)
            for j, o in enumerate(outs)]
    grads = []
    if case["grads"]:
        op = jreg.get_op(case["name"])
        attrs = jreg.attrs_to_str(case["attrs"])

        def f(*gs):
            xs = list(ins)
            for slot, g in zip(case["grads"], gs):
                xs[slot] = g
            out = op.compute(jreg.OpContext(is_train=True), attrs, xs, [])
            return list(out)

        _, vjp = jax.vjp(f, *[ins[i] for i in case["grads"]])
        grads = vjp([jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)])
    return ([(np.asarray(o.astype(jnp.float32)) if o.dtype == jnp.bfloat16
              else np.asarray(o), np.dtype(o.dtype).name) for o in outs],
            [np.asarray(g.astype(jnp.float32)) for g in grads], cots)


def port_run(case, cots, bf16=False):
    """The same for the port's op on CPU tensors."""
    tin = chip_smoke.sweep_tensors(torch, case, "cpu",
                                   torch.bfloat16 if bf16 else None)
    outs, _ = treg.invoke(case["name"], tin, case["attrs"], is_train=True)
    grads = []
    if case["grads"]:
        live = [(o, torch.from_numpy(c).to(o.dtype))
                for o, c in zip(outs, cots) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in live],
                                    [tin[i] for i in case["grads"]],
                                    [c for _, c in live], allow_unused=True)
        grads = [torch.zeros_like(tin[i]) if g is None else g
                 for i, g in zip(case["grads"], grads)]
    return ([(o.detach().float().numpy() if o.dtype == torch.bfloat16
              else o.detach().numpy(), dtype_name(o.dtype)) for o in outs],
            [g.float().numpy() for g in grads], outs)


def check_case(case, bf16=False):
    """Hold the port's op against the JAX op on one case: output count,
    shapes and dtypes, values (equal where ``exact``), gradients, and the
    port's ``infer_shape`` against the shapes it computed."""
    want, want_g, cots = jax_run(case, bf16)
    got, got_g, touts = port_run(case, cots, bf16)
    label = f"{case['name']} {case['attrs']}{' bf16' if bf16 else ''}"
    assert len(got) == len(want), label
    for (g, gdt), (w, wdt) in zip(got, want):
        assert gdt == wdt, f"{label}: dtype {gdt} vs JAX {wdt}"
        assert g.shape == w.shape, f"{label}: shape {g.shape} vs {w.shape}"
        if case["exact"]:
            np.testing.assert_array_equal(g, w, err_msg=label)
        elif bf16:
            _close_units(g, w, label)
        else:
            np.testing.assert_allclose(g, w, err_msg=label, **FWD)
    for g, w in zip(got_g, want_g):
        if bf16:
            _close_units(g, w, label + " grad", BF16_GRAD_UNITS)
        else:
            scale = max(1.0, float(np.nanmax(np.abs(w)))) if w.size else 1.0
            np.testing.assert_allclose(g, w, err_msg=label + " grad",
                                       rtol=GRAD["rtol"],
                                       atol=GRAD["atol"] * scale)
    op = treg.get_op(case["name"])
    attrs = treg.attrs_to_str(case["attrs"])
    _, shapes, _ = op.infer_shape(attrs, [tuple(a.shape)
                                          for a in case["ins"]])
    assert [tuple(s) for s in shapes] == [tuple(o.shape) for o in touts], \
        label


def _close_units(g, w, label, units=BF16_UNITS):
    scale = max(1.0, float(np.nanmax(np.abs(w)))) if w.size else 1.0
    err = np.nanmax(np.abs(g - w)) / scale if w.size else 0.0
    assert np.array_equal(np.isnan(g), np.isnan(w)), label
    assert err <= units, f"{label}: {err} of max(1, |JAX|)"
