"""bf16 and fp16 training and storage in the port against the JAX
package, on the CPU.

Types: ``infer_type`` of ``transformer_lm(dtype="bfloat16")`` and of a
bf16 ResNet (aux states included) as the JAX package infers them; the
MLP of ``tests/test_dtype_remat.py`` trained in fp16 and bf16 through
``Module`` from an ``NDArrayIter`` whose dtype binds the network.
Ops: ``LayerNorm``, ``BatchNorm``, ``SoftmaxCELoss`` and ``Cast``
forward and backward in bf16 against the JAX ops.  Steps: one SGD and
one Adam step of the bf16 LM (2 layers x 32 wide) through ``Module``
against the JAX ``Module`` from its parameters.  Serving: the bf16
``DecodeEngine`` (``dtype="bfloat16"``, ``kv_dtype="bf16"``, and with
``spec_tokens=4``) against the JAX engine.  The fused step's capture
runs on its warm-ups' stream (C14's repair, with ``torch.cuda``
replaced by a recorder).

Tolerances come from bf16's unit roundoff ``U`` = 2^-8 (8 significand
bits): one rounded result may sit one unit in the last place (2U of the
value) from another package's, which rounds its float32 intermediates
elsewhere; a chain of n roundings drifts by up to about nU.  Each
comparison names its count.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu.models import transformer_lm as jax_transformer_lm
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.module import fused_step
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke

U = 2.0 ** -8
BF16 = ml_dtypes.bfloat16
V, T, B = 61, 16, 4


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, mt.ndarray.HostBF16):
        return x.tensor().float().numpy()
    return np.asarray(x).astype(np.float32)


def _ulp(x):
    """One bf16 unit in the last place of each element of ``x``
    (float32 numpy)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

def _lms():
    kw = dict(num_layers=2, num_heads=2, d_model=32, head="ce",
              dtype="bfloat16")
    return jax_transformer_lm(V, T, **kw), \
        mt.models.transformer_lm(V, T, **kw)


def test_infer_type_of_the_bf16_lm_as_jax():
    """With the descriptors' float32 ids and labels (what ``bind``
    passes), every argument's type is the JAX package's:
    ``tok_embed_weight`` float32, every other parameter bf16."""
    js, ts = _lms()
    assert ts.list_arguments() == js.list_arguments()
    jt = js.infer_type(data="float32", softmax_label="float32")
    tt = ts.infer_type(data="float32", softmax_label="float32")
    for j, t in zip(jt, tt):
        assert [str(x) for x in j] == list(t)
    named = dict(zip(ts.list_arguments(), tt[0]))
    assert named["tok_embed_weight"] == "float32"
    assert {named[n] for n in named
            if n not in ("data", "softmax_label", "tok_embed_weight")} \
        == {"bfloat16"}
    # without a label type the JAX package types SoftmaxCELoss's label
    # as its data (bf16, which holds no id above 256 exactly); the port
    # keeps it float32, as SoftmaxOutput's in both packages
    at, _, _ = ts.infer_type(data="float32")
    assert dict(zip(ts.list_arguments(), at))["softmax_label"] == "float32"


def test_infer_type_of_a_bf16_resnet_as_jax():
    """ResNet-20 typed from bf16 data: weights, BatchNorm's gamma and
    beta and the output bf16, the moving statistics float32 (the aux
    dtype), as in the JAX package; ``simple_bind`` allocates each array
    in its type."""
    kw = dict(num_classes=10, num_layers=20, image_shape=(3, 32, 32))
    js, ts = jax_resnet(**kw), mt.models.resnet(**kw)
    jt = js.infer_type(data="bfloat16")
    tt = ts.infer_type(data="bfloat16")
    for j, t in zip(jt, tt):
        assert [str(x) for x in j] == list(t)
    assert set(tt[2]) == {"float32"} and len(tt[2]) > 0
    ex = ts.simple_bind(mt.cpu(), type_dict={"data": "bfloat16"},
                        data=(2, 3, 32, 32), softmax_label=(2,))
    for n, t in zip(ts.list_arguments(), tt[0]):
        assert ex.arg_dict[n]._data.dtype == mt.ndarray.torch_dtype(t)
    for n, t in zip(ts.list_auxiliary_states(), tt[2]):
        assert ex.aux_dict[n]._data.dtype == torch.float32


def test_variable_dtype_pin():
    """``Variable(dtype=...)`` pins propagate, and survive the JSON."""
    data = mt.sym.Variable("data", dtype="float16")
    net = mt.sym.FullyConnected(data, num_hidden=4, name="fc")
    for s in (net, mt.sym.load_json(net.tojson())):
        at, ot, _ = s.infer_type()
        assert at == ["float16"] * 3 and ot == ["float16"]


# ---------------------------------------------------------------------------
# the MLP of tests/test_dtype_remat.py:33-69 through Module
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_data(n=300, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    y = np.argmax(X @ rng.randn(8, 3), axis=1).astype(np.float32)
    return X, y


def _fit_mlp(pkg, ctx, X, y, dtype):
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    it = pkg.io.NDArrayIter(X, y, batch_size=20)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    types = {n: str(a.dtype) for n, a in mod._exec.arg_dict.items()}
    if pkg is mt:
        types = {n: mt.ndarray.dtype_name(a._data.dtype)
                 for n, a in mod._exec.arg_dict.items()}
    pkg.random.seed(0)
    mod.init_params(pkg.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.2, "momentum": 0.9})
    for _ in range(8):
        it.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
    acc = mod.score(pkg.io.NDArrayIter(X, y, batch_size=20), "acc")[0][1]
    return types, acc


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_low_precision_mlp_trains_as_jax(dtype):
    """An ``NDArrayIter`` over ``dtype`` data binds every parameter of
    the MLP in ``dtype`` in both packages (the label stays float32), and
    both train it past the JAX test's 0.8 accuracy."""
    X, y = _mlp_data()
    Xd = X.astype(dtype)
    jtypes, jacc = _fit_mlp(mx, mx.cpu(), Xd, y, dtype)
    ttypes, tacc = _fit_mlp(mt, mt.cpu(), Xd, y, dtype)
    assert ttypes == jtypes
    assert ttypes["fc1_weight"] == ttypes["fc2_bias"] == dtype
    assert ttypes["softmax_label"] == "float32"
    assert jacc > 0.8 and tacc > 0.8, (jacc, tacc)


@pytest.mark.parametrize("source", ["ml_dtypes", "ndarray", "tensor"])
def test_ndarray_iter_keeps_a_bf16_source(source):
    """A bf16 source (an ``ml_dtypes`` array, a bf16 NDArray or tensor)
    is described as "bfloat16" and batched bit for bit; ``ResizeIter``
    passes the description on."""
    X, y = _mlp_data(40)
    ref = torch.from_numpy(X).to(torch.bfloat16)
    src = {"ml_dtypes": X.astype(BF16),
           "ndarray": mt.nd.array(ref, ctx=mt.cpu()),
           "tensor": ref}[source]
    it = mt.io.NDArrayIter(src, y, batch_size=10)
    assert it.provide_data[0].dtype == "bfloat16"
    assert np.dtype(it.provide_label[0].dtype) == np.float32
    rs = mt.io.ResizeIter(it, 3)
    assert rs.provide_data[0].dtype == "bfloat16"
    batch = next(iter(it))
    assert torch.equal(batch.data[0]._data, ref[:10])


def test_bucketing_module_binds_buckets_in_the_descriptors_dtype():
    """``BucketingModule`` binds each bucket through ``Module.bind``, so a
    bf16 descriptor types every bucket's parameters bf16, shared between
    buckets (one storage), and a bucket trains a step."""
    def sym_gen(key):
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=3, flatten=False,
                                    name="fc")
        out = mt.sym.SoftmaxOutput(net, preserve_shape=True, name="softmax")
        return out, ("data",), ("softmax_label",)

    def descs(key):
        return ([mt.io.DataDesc("data", (2, key, 8), "bfloat16")],
                [mt.io.DataDesc("softmax_label", (2, key))])

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                 context=mt.cpu())
    mod.bind(*descs(6))
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod.switch_bucket(4, *descs(4))
    a, b = (mod._buckets[k]._exec.arg_dict for k in (6, 4))
    assert a["fc_weight"] is b["fc_weight"]
    assert a["fc_weight"]._data.dtype == torch.bfloat16
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randn(2, 4, 8).astype(np.float32)).to(
        torch.bfloat16)
    before = a["fc_weight"]._data.clone()
    mod.forward_backward(mt.io.DataBatch(
        [mt.nd.array(X, ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, 3, (2, 4)).astype(np.float32),
                     ctx=mt.cpu())], bucket_key=4,
        provide_data=descs(4)[0], provide_label=descs(4)[1]))
    mod.update()
    assert a["fc_weight"]._data.dtype == torch.bfloat16
    assert not torch.equal(a["fc_weight"]._data, before)


# ---------------------------------------------------------------------------
# ops in bf16 against the JAX ops
# ---------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32).astype(BF16)


def _op_pair(name, inputs, attrs, grad_slots, aux=(), is_train=False,
             seed=0):
    """Forward outputs, new aux states and the gradients of
    ``grad_slots`` under one seeded bf16 cotangent (for the first
    output), JAX then the port → ((outs, aux, grads), (outs, aux,
    grads)) as float32 numpy, after checking the dtypes agree."""
    import jax

    def jfun(*xs):
        outs, new_aux = jax_invoke(name, list(xs), attrs, is_train=is_train,
                                   aux=[jnp.asarray(a) for a in aux])
        return outs[0], (outs, new_aux)

    jout, vjp, (jouts, jaux) = jax.vjp(jfun, *[jnp.asarray(x)
                                               for x in inputs],
                                       has_aux=True)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(
        np.float32).astype(jout.dtype)
    jgrads = vjp(jnp.asarray(cot))

    tin = [mt.ndarray.tensor_from_numpy(x) for x in inputs]
    for s in grad_slots:
        tin[s].requires_grad_(True)
    touts, taux = torch_invoke(name, tin, attrs, is_train=is_train,
                               aux=[mt.ndarray.tensor_from_numpy(a)
                                    for a in aux])
    tgrads = torch.autograd.grad(touts[0], [tin[s] for s in grad_slots],
                                 mt.ndarray.tensor_from_numpy(cot))
    for j, t in zip(list(jouts) + list(jaux), list(touts) + list(taux)):
        assert mt.ndarray.dtype_name(t.dtype) == str(j.dtype)
    for s, g in zip(grad_slots, tgrads):
        assert mt.ndarray.dtype_name(g.dtype) == str(jgrads[s].dtype)
    return (([_f32(x) for x in jouts], [_f32(x) for x in jaux],
             [_f32(jgrads[s]) for s in grad_slots]),
            ([_f32(x) for x in touts], [_f32(x) for x in taux],
             [_f32(g) for g in tgrads]))


def _close(got, want, n_roundings, what):
    """|got - want| within n bf16 roundings of the largest reference
    value: n * U * max|want|."""
    tol = n_roundings * U * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {n_roundings} U max|ref| = {tol}"


# op, inputs, attrs, grad slots, aux, is_train, roundings of the forward
# and of the gradients (the backward chains more roundings)
def _op_cases():
    rng = np.random.RandomState(0)
    x3 = _bf16(rng, 4, 6, 32)
    g, b = _bf16(rng, 32, scale=0.5), _bf16(rng, 32, scale=0.5)
    x4 = _bf16(rng, 4, 8, 5, 5, scale=2.0)
    bg, bb = _bf16(rng, 8), _bf16(rng, 8)
    mm = rng.randn(8).astype(np.float32)
    mv = np.abs(rng.randn(8)).astype(np.float32) + 0.5
    logits = _bf16(rng, 4, 6, 61, scale=2.0)
    labels = rng.randint(0, 61, (4, 6)).astype(np.float32)
    labels[0, :2] = 0  # ignored
    xc = rng.randn(4, 6, 32).astype(np.float32)
    return {
        "LayerNorm": (("LayerNorm", [x3, g, b], {}, (0, 1, 2), (), False),
                      2, 2),
        "BatchNorm": (("BatchNorm", [x4, bg, bb], {"fix_gamma": "False"},
                       (0, 1, 2), (mm, mv), True), 2, 2),
        "SoftmaxCELoss": (("SoftmaxCELoss", [logits, labels],
                           {"use_ignore": "True", "ignore_label": "0"},
                           (0,), (), False), 2, 2),
        "Cast": (("Cast", [xc], {"dtype": "bfloat16"}, (0,), (), False),
                 0, 0)}


@pytest.mark.parametrize("op", ["LayerNorm", "BatchNorm", "SoftmaxCELoss",
                                "Cast"])
def test_op_in_bf16_as_jax(op):
    """Forward (outputs and new moving statistics) and gradients of
    each op in bf16 against the JAX op, dtypes equal: LayerNorm's and
    BatchNorm's statistics in float32 with the output in bf16 (the
    moving statistics in their float32), SoftmaxCELoss float32 inside
    with a bf16 gradient, Cast's gradient in its input's float32.
    Outputs and gradients within one bf16 unit in the last place of the
    largest reference value (2U of it: each package rounds once, from
    float32 intermediates that may differ in their last bits; these
    shapes measured 0); Cast exactly."""
    (args, n_fwd, n_bwd) = _op_cases()[op]
    (jouts, jaux, jgrads), (touts, taux, tgrads) = _op_pair(*args)
    for i, (t, j) in enumerate(zip(touts + taux, jouts + jaux)):
        if n_fwd == 0:
            np.testing.assert_array_equal(t, j)
        else:
            _close(t, j, n_fwd, f"{op} output {i}")
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        if n_bwd == 0:
            np.testing.assert_array_equal(t, j)
        else:
            _close(t, j, n_bwd, f"{op} gradient {i}")


# ---------------------------------------------------------------------------
# one SGD and one Adam step of the bf16 LM against the JAX Module
# ---------------------------------------------------------------------------

# the gradient chain of the bf16 LM: its backward through two blocks
# rounds a gradient in bf16 at ~16 ops (matmuls, the LayerNorms, GELU,
# the attention); the packages round their float32 intermediates in
# other places, so a gradient may drift by 16 U of its largest value
# (measured: at most 2.9e-2 of it, ~7.4 U)
GRAD_ROUNDINGS = 16


def _lm_batch(pkg, ctx, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randint(1, V, (B, T)).astype(np.float32)
    Y = rng.randint(0, V, (B, T)).astype(np.float32)
    return pkg.io.DataBatch([pkg.nd.array(X, ctx=ctx)],
                            [pkg.nd.array(Y, ctx=ctx)])


def _lm_modules(optimizer, opt_params, monkeypatch, fused):
    """The JAX Module (its own initial parameters) and the port's from
    them, each after one step on one batch; the JAX module's fused
    states file is ``states`` (bytes).  ``fused`` picks both packages'
    fused step or the eager Updater path."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    js, ts = _lms()
    shapes = dict(data_shapes=[("data", (B, T))],
                  label_shapes=[("softmax_label", (B, T))])
    jm = mx.mod.Module(js, context=mx.cpu())
    jm.bind(data_shapes=[mx.io.DataDesc("data", (B, T))],
            label_shapes=[mx.io.DataDesc("softmax_label", (B, T))])
    mx.random.seed(0)
    jm.init_params(mx.initializer.Xavier())
    start = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}
    jm.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    tm = mt.mod.Module(ts, context=mt.cpu())
    tm.bind(data_shapes=[mt.io.DataDesc(n, s)
                         for n, s in shapes["data_shapes"]],
            label_shapes=[mt.io.DataDesc(n, s)
                          for n, s in shapes["label_shapes"]])
    tm.init_params(arg_params=start)
    tm.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    for m, pkg, ctx in ((jm, mx, mx.cpu()), (tm, mt, mt.cpu())):
        m.forward_backward(_lm_batch(pkg, ctx))
        m.update()
    return jm, tm, start


def _step_outputs(jm, tm):
    jo = np.asarray(jm.get_outputs()[0].asnumpy(), np.float32)
    to = tm.get_outputs()[0]._data.float().numpy()
    # the per-token loss: float32 from bf16 logits (2 roundings apart)
    _close(to, jo, 2, "per-token loss")


def test_bf16_lm_sgd_step_as_jax(monkeypatch):
    """One SGD step (lr 0.5, momentum 0.9, wd 1e-4) of the bf16 LM
    through both packages' fused step from the JAX module's parameters:
    the parameter dtypes agree (``tok_embed_weight`` float32, the rest
    bf16), and each new weight lies within one bf16 ulp of the JAX
    weight plus lr times the gradient tolerance (``GRAD_ROUNDINGS`` U
    of the largest gradient): w1 = w0 - lr (g + wd w0), rounded once."""
    lr = 0.5
    jm, tm, start = _lm_modules("sgd", {"learning_rate": lr,
                                        "momentum": 0.9, "wd": 1e-4},
                                monkeypatch, fused=True)
    _step_outputs(jm, tm)
    jp = jm.get_params()[0]
    tp = tm.get_params()[0]
    moved = 0
    for n, a in jp.items():
        assert mt.ndarray.dtype_name(tp[n]._data.dtype) == str(a.dtype), n
        want, got = _f32(a.asnumpy()), _f32(tp[n]._data)
        g_bound = np.abs(want - start[n].astype(np.float32)).max() / lr
        tol = _ulp(want) + lr * GRAD_ROUNDINGS * U * g_bound
        assert np.all(np.abs(got - want) <= tol), n
        moved += int(np.any(got != start[n].astype(np.float32)))
    assert moved == len(jp)
    assert str(jp["tok_embed_weight"].dtype) == "float32"


def test_bf16_lm_adam_step_as_jax(monkeypatch, tmp_path):
    """One Adam step (lr 1e-3) of the bf16 LM as above.  The moments,
    read from the JAX module's states file by the port's reader (bf16
    ``ml_dtypes`` arrays), lie within the gradient tolerance of the
    port's: m = 0.1 g within 0.1 x ``GRAD_ROUNDINGS`` U of max|g|, v =
    0.001 g^2 within 2 x that relative tolerance of max v.  Adam's first
    step is lr sign(g) (up to its rounding): each new weight lies within
    one ulp + lr 2^-5 of the JAX weight, except where the JAX moment is
    inside its own tolerance (a gradient that bf16's noise may give
    either sign), where the two may be 2 lr apart."""
    lr = 1e-3
    jm, tm, _ = _lm_modules("adam", {"learning_rate": lr}, monkeypatch,
                            fused=True)
    _step_outputs(jm, tm)
    fname = str(tmp_path / "jax.states")
    jm.save_optimizer_states(fname)
    with open(fname, "rb") as f:
        jstates = mt.checkpoint.loads(f.read())["states"]
    tstates = tm._fused.states
    jp, tp = jm.get_params()[0], tm.get_params()[0]
    flips = 0
    for n, (jmom, jvar) in jstates.items():
        m_j, v_j = _f32(jmom), _f32(jvar)
        m_t, v_t = _f32(tstates[n][0]), _f32(tstates[n][1])
        assert tstates[n][0].dtype == tp[n]._data.dtype
        m_tol = GRAD_ROUNDINGS * U * np.abs(m_j).max()
        assert np.abs(m_t - m_j).max() <= m_tol, n
        assert np.abs(v_t - v_j).max() <= \
            2 * GRAD_ROUNDINGS * U * np.abs(v_j).max(), n
        want, got = _f32(jp[n].asnumpy()), _f32(tp[n]._data)
        apart = np.abs(got - want) > _ulp(want) + lr * 2 ** -5
        assert np.all(np.abs(m_j[apart]) <= m_tol), n
        assert np.all(np.abs(got - want) <= _ulp(want) + 2 * lr), n
        flips += int(apart.sum())
    total = sum(int(np.prod(a.shape)) for a in jp.values())
    assert flips <= 0.05 * total, (flips, total)


# ---------------------------------------------------------------------------
# bf16 serving against the JAX engine
# ---------------------------------------------------------------------------

# the port serves a bf16 LM in bf16 activations (the training symbol's
# embed_cast), the JAX engine its bf16 weights against float32
# activations (its decode trunk has no cast): the logits part by the
# port's roundings of the activations, a few U of the largest logit
# (measured at most 1.9 U over the prompts below); twice that
LOGIT_ROUNDINGS = 4


def _bf16_lm():
    import torch_serving_parity as sp

    host, _ = sp.make_lm(0)
    return sp, {k: (v if k == "tok_embed_weight" else v.astype(BF16))
                for k, v in host.items()}


def test_bf16_serving_chain_logits_as_jax():
    """The port's serving chain over the bf16 parameters (``params_from
    _numpy(dtype=None)`` keeps them bf16): its full forward, prefill and
    bf16-page decode logits along a chain within ``LOGIT_ROUNDINGS`` U
    of the largest JAX logit of the JAX full forward."""
    sp, bf = _bf16_lm()
    dev = mt.params_from_numpy(bf, "cpu", dtype=None)
    assert dev["tok_embed_weight"].dtype == torch.float32
    assert dev["layer0_qkv_weight"].dtype == torch.bfloat16
    port = mt.models.transformer.TransformerLM(
        dev, num_layers=sp.L, num_heads=sp.H, kv_block=sp.KVB)
    rng = np.random.RandomState(5)
    for n in (5, 9, 13):
        prompt, gen = rng.randint(1, V, n), rng.randint(1, V, 8)
        ref = sp.jax_full_rows(bf, prompt, gen)
        seq = np.concatenate([prompt, gen]).astype(np.int64)
        full = port.forward(torch.from_numpy(seq[None]))[0].numpy()
        _close(full[n - 1:len(seq) - 1], ref, LOGIT_ROUNDINGS,
               f"full forward, prompt {n}")
        # the chain as the engine runs it: prefill, then one decode step
        # a token over bf16 pages
        P = 1 + -(-len(seq) // sp.KVB)
        pools = [torch.zeros((P, sp.KVB, sp.H, sp.D), dtype=torch.bfloat16)
                 for _ in range(2 * sp.L)]
        table = torch.arange(1, P, dtype=torch.int32)[None]
        tp = -(-n // sp.KVB) * sp.KVB
        tok = torch.zeros((1, tp), dtype=torch.int64)
        tok[0, :n] = torch.from_numpy(seq[:n])
        rows = [port.prefill(tok, torch.arange(tp)[None],
                             torch.tensor([n], dtype=torch.int32),
                             table[:, :tp // sp.KVB], pools)[0, n - 1]]
        for i in range(len(gen) - 1):
            rows.append(port.decode(
                torch.tensor([[int(gen[i])]]), torch.tensor([[n + i]]),
                torch.tensor([n + i + 1], dtype=torch.int32), table,
                pools)[0, 0])
        assert rows[0].dtype == torch.float32
        _close(torch.stack(rows).numpy(), ref, LOGIT_ROUNDINGS,
               f"prefill + decode, prompt {n}")


@pytest.mark.parametrize("mode", [dict(dtype="bfloat16"),
                                  dict(kv_dtype="bf16"),
                                  dict(dtype="bfloat16", spec_tokens=4)],
                         ids=["dtype", "kv_dtype", "spec"])
def test_bf16_engine_greedy_chains_as_jax(mode):
    """The bf16 LM served by both engines with bf16 pages (``dtype=
    "bfloat16"`` or ``kv_dtype="bf16"``; plain and with ``spec_tokens=4``
    and the n-gram proposer): the port's parameters stay in their dtypes
    and its pools are bf16; the greedy chains are equal up to each
    chain's first position whose JAX full-forward top-2 margin is within
    the logits' tolerance (``LOGIT_ROUNDINGS`` U of the row's largest
    logit), and at least half of all tokens are compared."""
    sp, bf = _bf16_lm()
    rng = np.random.RandomState(11)
    jobs = [(rng.randint(1, V, n).astype(np.int32), 10)
            for n in (3, 6, 9, 12)]
    ref, _ = sp.serve(mx.DecodeEngine, bf, jobs, prefix_cache=0,
                      ctx=mx.cpu(), **mode)
    with mt.DecodeEngine(bf, **sp.engine_kw(ctx=mt.cpu(), **mode)) as eng:
        params = dict(eng._model.named_parameters())
        assert params["tok_embed_weight"].dtype == torch.float32
        assert {p.dtype for n, p in params.items()
                if n != "tok_embed_weight"} == {torch.bfloat16}
        assert {p.dtype for p in eng._pools} == {torch.bfloat16}
        futs = [eng.submit(p, k) for p, k in jobs]
        outs = [np.asarray(f.result(timeout=300)) for f in futs]
    compared = 0
    for (prompt, _), r, got in zip(jobs, ref, outs):
        rows = sp.jax_full_rows(bf, prompt, r)
        for i in range(len(r)):
            top2 = np.sort(rows[i])[-2:]
            if top2[1] - top2[0] <= LOGIT_ROUNDINGS * U * np.abs(
                    rows[i]).max():
                break
            assert got[i] == r[i], (mode, prompt, i, r, got)
            compared += 1
    assert compared * 2 >= sum(len(r) for r in ref), compared


# ---------------------------------------------------------------------------
# C14's repair: the capture runs on the warm-ups' stream
# ---------------------------------------------------------------------------

class _CudaRecorder:
    """Stands for ``torch.cuda`` inside ``fused_step.Graphed``: records
    the calls in order, with the stream current at each."""

    def __init__(self):
        self.log = []
        self.current = "main"

    def stream_obj(self, name):
        rec = self

        class Stream:
            def __init__(self):
                self.name = name

            def wait_stream(self, other):
                rec.log.append(("wait", self.name, other.name))

        return Stream()

    def install(self, monkeypatch):
        import torch.cuda as tc

        rec = self
        made = iter(["side", "other"])

        class Graph:
            def register_generator_state(self, g):
                pass

            def capture_begin(self, pool, capture_error_mode="global"):
                rec.log.append(("capture_begin", rec.current,
                                capture_error_mode, pool))

            def capture_end(self):
                rec.log.append(("capture_end", rec.current))

            def replay(self):
                rec.log.append(("replay", rec.current))

        class StreamCtx:
            def __init__(self, s):
                self.s, self.old = s, None

            def __enter__(self):
                self.old, rec.current = rec.current, self.s.name

            def __exit__(self, *exc):
                rec.current = self.old

        monkeypatch.setattr(tc, "Stream", lambda: rec.stream_obj(next(made)))
        monkeypatch.setattr(tc, "current_stream",
                            lambda: rec.stream_obj(rec.current))
        monkeypatch.setattr(tc, "stream", StreamCtx)
        monkeypatch.setattr(tc, "CUDAGraph", Graph)
        monkeypatch.setattr(tc, "synchronize",
                            lambda: rec.log.append(("synchronize",)))
        monkeypatch.setattr(tc, "empty_cache",
                            lambda: rec.log.append(("empty_cache",)))
        monkeypatch.setattr(torch._C, "_host_emptyCache",
                            lambda: rec.log.append(("host_empty_cache",)),
                            raising=False)
        monkeypatch.setattr(tc, "memory_reserved", lambda: 0)


def test_capture_runs_on_the_warm_up_stream(monkeypatch):
    """``Graphed`` warms up on its side stream, then captures on that
    same stream (``capture_begin`` with the side stream current, in the
    ``thread_local`` mode, into the module's pool), after emptying the
    device's and the pinned host cache and with the garbage collector
    off, and replays on the caller's stream: cuBLAS's and cuDNN's
    per-stream state is the warm-ups' (C14, C15)."""
    import gc

    rec = _CudaRecorder()
    rec.install(monkeypatch)

    class Step:
        streams = mt.random.Streams(0)
        data = [torch.zeros(2)]

        def arrays(self):
            return self.data

        def __call__(self):
            rec.log.append(("step", rec.current, gc.isenabled()))
            return [torch.ones(2)]

    g = fused_step.Graphed(Step(), lambda: "pool")
    for _ in range(fused_step._WARMUP_STEPS + 2):
        out = g()
        assert torch.equal(out[0], torch.ones(2))
    steps = [e for e in rec.log if e[0] == "step"]
    assert steps == [("step", "side", True)] * fused_step._WARMUP_STEPS \
        + [("step", "side", False)]
    begin = next(i for i, e in enumerate(rec.log) if e[0] == "capture_begin")
    assert rec.log[begin] == ("capture_begin", "side", "thread_local",
                              "pool")
    assert rec.log[begin + 1] == ("step", "side", False)
    assert rec.log[begin + 2] == ("capture_end", "side")
    assert gc.isenabled()
    last_warm_up = max(i for i, e in enumerate(rec.log[:begin])
                       if e[0] == "step")
    for e in (("empty_cache",), ("host_empty_cache",)):
        assert rec.log.count(e) == 1
        assert last_warm_up < rec.log.index(e) < begin
    assert [e for e in rec.log if e[0] == "replay"] == [("replay", "main")] * 2
    assert g.captures == 1 and g.graph is not None


@pytest.mark.parametrize("fused", ["1", "0"])
def test_steps_keep_cudnn_to_its_deterministic_algorithms(monkeypatch,
                                                          fused):
    """The executor's forward and backward, in the fused step and on the
    eager path, run with ``torch.backends.cudnn.deterministic`` on, and
    the process's setting is back after the step (C14: the default
    algorithms part two runs of one step)."""
    from mxnet_tpu_torch.ops.registry import get_op

    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    seen = []
    fc = get_op("FullyConnected")
    compute = fc.compute

    def spy(op_ctx, attrs, inputs, aux):
        seen.append(("forward", torch.backends.cudnn.deterministic))
        out = compute(op_ctx, attrs, inputs, aux)
        out[0].register_hook(lambda g: seen.append(
            ("backward", torch.backends.cudnn.deterministic)))
        return out

    monkeypatch.setattr(fc, "compute", spy)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=3), name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    assert torch.backends.cudnn.deterministic is False
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.rand(4, 5).astype(np.float32), ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, 3, 4).astype(np.float32),
                     ctx=mt.cpu())])
    mod.forward_backward(batch)
    mod.update()
    assert seen == [("forward", True), ("backward", True)]
    assert torch.backends.cudnn.deterministic is False


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_update_of_a_list_of_mixed_dtypes(optimizer):
    """``apply`` over one list of float32 and bf16 weights (the bf16 LM's
    one group holds the float32 ``tok_embed_weight``) updates each weight
    as the per-weight ``_step`` (the eager path) does, bit for bit, and
    the bf16 weight with no master copy: SGD's new momentum and weight
    formed in float32 from the bf16 values and rounded once."""
    lr, wd, mom = 0.5, 1e-2, 0.9
    opt = mt.optimizer.create(optimizer, learning_rate=lr, wd=wd,
                              **({"momentum": mom} if optimizer == "sgd"
                                 else {}))
    rng = np.random.RandomState(3)
    ws = [torch.from_numpy(rng.randn(6, 5).astype(np.float32)),
          torch.from_numpy(rng.randn(7).astype(np.float32))
          .to(torch.bfloat16)]
    gs = [torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
          .to(w.dtype) for w in ws]
    states = opt.init_state_arrays(ws)
    states = [tuple(torch.randn_like(x.float()).to(x.dtype) for x in s)
              if isinstance(s, tuple) else torch.randn_like(s.float())
              .to(s.dtype) for s in states]
    if optimizer == "adam":
        states = [(m, v.abs()) for m, v in states]

    def clone(tree):
        return tuple(x.clone() for x in tree) if isinstance(tree, tuple) \
            else tree.clone()

    w_list, s_list = [w.clone() for w in ws], [clone(s) for s in states]
    w_one, s_one = [w.clone() for w in ws], [clone(s) for s in states]
    with torch.no_grad():
        opt.apply(w_list, [g.clone() for g in gs], s_list, lr, wd, 1)
        for w, g, s in zip(w_one, gs, s_one):
            opt._step(w, g.clone(), s, lr, wd, 1)
    for a, b in zip(w_list + s_list, w_one + s_one):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert [w.dtype for w in w_list] == [torch.float32, torch.bfloat16]
    if optimizer == "sgd":
        g32 = gs[1].float().add_(ws[1], alpha=wd).mul_(lr)
        m32 = states[1].float().mul_(mom).sub_(g32)
        assert torch.equal(s_list[1], m32.to(torch.bfloat16))
        assert torch.equal(w_list[1],
                           (ws[1].float() + m32).to(torch.bfloat16))
