"""The port's checkpoint files against the JAX package's, both ways, on
the CPU: ``nd.save``/``nd.load`` for every dtype code, the symbol JSON of
every family of ``mxnet_tpu_torch/models/``, ``model.save_checkpoint``/
``load_checkpoint`` (with the errors that name a missing or corrupt
file), and ``Module`` checkpoints with optimizer states, fused and as
the ``Updater`` blob, from which both packages train on and agree.

Tolerances: files and arrays are exact (the formats are byte for byte
the same); the forward of a symbol loaded from the other package's JSON
is held to the forward of the same package's own symbol at ``FWD``
(rtol = atol = 1e-5, ``tests/test_torch_module.py``); three steps after
a cross-package load are held to the other package's three steps at
``GRAD`` (rtol = atol = 5e-5, the tolerance of updated weights there).
"""

import os
import pickle
import struct
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer_lm as jax_transformer_lm
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.ssd import ssd300_symbol, synthetic_boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_ckpt_crash_worker as W  # noqa: E402

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


# ---------------------------------------------------------------------------
# nd.save / nd.load
# ---------------------------------------------------------------------------

DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
          "int64", "bfloat16", "bool"]
# the JAX package runs without x64: it holds no 64-bit arrays to save
JAX_HOLDS = [d for d in DTYPES if d not in ("float64", "int64")]


def _values(dtype, shape=(3, 4), seed=0):
    base = np.random.RandomState(seed).randn(*shape) * 20
    if dtype == "bool":
        return base > 0
    if dtype == "bfloat16":
        return base.astype(np.float32)
    return base.astype(dtype)


def _port_array(dtype, x):
    t = torch.from_numpy(np.array(x))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return mt.nd.NDArray(t, mt.cpu())


def _bits(arr, dtype):
    """The values of an NDArray of either package, bf16 as its bits."""
    if isinstance(arr, mt.nd.NDArray):
        t = arr._data
        return (t.view(torch.int16) if dtype == "bfloat16" else t).numpy()
    a = arr.asnumpy()
    return a.view(np.int16) if dtype == "bfloat16" else a


def _code(path):
    """The dtype code of the first array of a one-entry dict file."""
    with open(path, "rb") as f:
        f.read(17)
        klen, = struct.unpack("<I", f.read(4))
        f.read(klen)
        return struct.unpack("<I", f.read(4))[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_nd_save_load_each_dtype_code_both_ways(dtype, tmp_path):
    x = _values(dtype, seed=DTYPES.index(dtype))
    tarr = _port_array(dtype, x)
    pfile, jfile = str(tmp_path / "port.nd"), str(tmp_path / "jax.nd")
    mt.nd.save(pfile, {"x": tarr})
    assert _code(pfile) == DTYPES.index(dtype)
    back = mt.nd.load(pfile)["x"]
    assert back._data.dtype == tarr._data.dtype
    assert back.context == mt.cpu()
    np.testing.assert_array_equal(_bits(back, dtype), _bits(tarr, dtype))
    if dtype not in JAX_HOLDS:
        # the JAX package reads the port's file into its 32-bit type
        got = mx.nd.load(pfile)["x"].asnumpy()
        np.testing.assert_array_equal(got, x.astype(got.dtype))
        return
    jarr = mx.nd.array(np.array(x), dtype=dtype)
    mx.nd.save(jfile, {"x": jarr})
    with open(pfile, "rb") as a, open(jfile, "rb") as b:
        assert a.read() == b.read(), "the files differ byte for byte"
    np.testing.assert_array_equal(_bits(mt.nd.load(jfile)["x"], dtype),
                                  _bits(jarr, dtype))
    np.testing.assert_array_equal(_bits(mx.nd.load(pfile)["x"], dtype),
                                  _bits(tarr, dtype))


def test_nd_save_load_list_dict_and_0dim_both_ways(tmp_path):
    scalar = np.array(3.5, np.float32)
    mat = np.arange(6, dtype=np.int32).reshape(2, 3)
    p = str(tmp_path / "p.nd")
    mt.nd.save(p, [mt.nd.array(scalar, ctx=mt.cpu()),
                   mt.nd.array(mat, ctx=mt.cpu())])
    lst = mx.nd.load(p)
    assert isinstance(lst, list) and len(lst) == 2
    assert lst[0].shape == () and float(lst[0].asnumpy()) == 3.5
    np.testing.assert_array_equal(lst[1].asnumpy(), mat)
    j = str(tmp_path / "j.nd")
    mx.nd.save(j, {"s": mx.nd.array(scalar), "m": mx.nd.array(mat)})
    d = mt.nd.load(j)
    assert list(d) == ["s", "m"] and d["s"].shape == ()
    assert float(d["s"].asnumpy()) == 3.5
    np.testing.assert_array_equal(d["m"].asnumpy(), mat)
    mx.nd.save(j, [mx.nd.array(mat)])
    one = str(tmp_path / "one.nd")
    mt.nd.save(one, mt.nd.array(mat, ctx=mt.cpu()))  # one array: a list
    with open(one, "rb") as a, open(j, "rb") as b:
        assert a.read() == b.read()
    with open(one, "wb") as f:
        f.write(b"not an NDArray file at all")
    with pytest.raises(mt.MXNetError, match="one"):
        mt.nd.load(one)


# ---------------------------------------------------------------------------
# the symbol JSON of every family
# ---------------------------------------------------------------------------

def _zoo(name, **kw):
    return lambda pkg: pkg.models.get_symbol(name, **kw)


FAMILIES = {
    # family: (a function of the package giving its symbol, data shape)
    "mlp": (_zoo("mlp", num_classes=10), (2, 1, 28, 28)),
    "lenet": (_zoo("lenet", num_classes=10), (2, 1, 28, 28)),
    "resnet-20": (_zoo("resnet-20", num_classes=10,
                       image_shape=(3, 32, 32)), (2, 3, 32, 32)),
    "alexnet": (_zoo("alexnet", num_classes=10), (1, 3, 67, 67)),
    "vgg": (_zoo("vgg", num_classes=10), (1, 3, 32, 32)),
    "inception-bn": (_zoo("inception-bn", num_classes=10), (1, 3, 64, 64)),
    "inception-v3": (_zoo("inception-v3", num_classes=10), (1, 3, 75, 75)),
    "ssd300": (lambda pkg: ssd300_symbol(filters_div=16, symbol_api=pkg.sym
                                         )[1], (1, 3, 300, 300)),
    "ssd300-train": (lambda pkg: ssd300_symbol(filters_div=16,
                                               symbol_api=pkg.sym)[0], None),
    "transformer_lm": (lambda pkg: (jax_transformer_lm if pkg is mx
                                    else mt.models.transformer_lm)(
        61, 16, num_layers=2, num_heads=2, d_model=32), (4, 16)),
}


def _inputs(sym, dshape, seed=0):
    """Random arguments and aux states for ``sym`` with data ``dshape``
    (token ids for a 2-d shape; positive variances)."""
    shapes = {"data": dshape}
    given = {}
    if "label" in sym.list_arguments():  # SSD300's boxes
        given["data"], given["label"] = synthetic_boxes(dshape[0])
        shapes["label"] = given["label"].shape
    if "softmax_label" in sym.list_arguments():
        shapes["softmax_label"] = dshape if len(dshape) == 2 \
            else (dshape[0],)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in given:
            args[n] = given[n]
        elif n == "data" and len(dshape) == 2:
            args[n] = rng.randint(0, 61, s).astype(np.float32)
        elif n == "softmax_label":
            args[n] = np.zeros(s, np.float32)
        else:
            args[n] = (rng.randn(*s) * (0.5 if n == "data" else 0.1)
                       ).astype(np.float32)
    aux = {n: (np.abs(rng.randn(*s)) + 0.5 if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _forward(pkg, sym, args, aux):
    arr = (lambda v: mt.nd.array(v, ctx=mt.cpu())) if pkg is mt \
        else mx.nd.array
    ex = sym.bind(pkg.cpu(), {k: arr(v) for k, v in args.items()},
                  grad_req="null",
                  aux_states={k: arr(v) for k, v in aux.items()})
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def _same_interface(a, b):
    assert a.list_arguments() == b.list_arguments()
    assert a.list_outputs() == b.list_outputs()
    assert a.list_auxiliary_states() == b.list_auxiliary_states()
    assert a.attr_dict() == b.attr_dict()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_symbol_json_loads_across_packages(family, tmp_path):
    """JAX ``tojson`` → the port's ``load_json``: the JAX symbol's
    arguments, outputs, aux states and attrs, the same JSON text written
    back, and its forward equal to the port's own symbol's; then the
    port's ``save`` → the JAX ``load``, likewise.  (Two symbols built
    apart differ in the auto-generated names of their op nodes, which
    count the nodes made before in the process.)"""
    build, dshape = FAMILIES[family]
    jsym, tsym = build(mx), build(mt)
    t_loaded = mt.sym.load_json(jsym.tojson())
    _same_interface(t_loaded, jsym)
    assert t_loaded.tojson() == jsym.tojson()
    tsym.save(str(tmp_path / "s.json"))
    j_loaded = mx.sym.load(str(tmp_path / "s.json"))
    _same_interface(j_loaded, tsym)
    assert j_loaded.tojson() == tsym.tojson()
    if dshape is None:
        return
    args, aux = _inputs(tsym, dshape)
    for pkg, loaded, own in ((mt, t_loaded, tsym), (mx, j_loaded, jsym)):
        for a, b in zip(_forward(pkg, loaded, args, aux),
                        _forward(pkg, own, args, aux)):
            np.testing.assert_allclose(a, b, err_msg=f"{pkg.__name__}",
                                       **FWD)


def test_symbol_json_legacy_param_and_unported_op():
    data = mt.sym.Variable("data")
    fc = mt.sym.FullyConnected(data, num_hidden=4, name="fc")
    doc = fc.tojson().replace('"attr"', '"param"')
    legacy = mt.sym.load_json(doc)
    assert legacy.list_arguments() == ["data", "fc_weight", "fc_bias"]
    assert legacy.attr_dict()["fc"]["num_hidden"] == "4"
    # an op the port registers since its operator layer loads ...
    jsym = mx.sym.Correlation(mx.sym.Variable("a"), mx.sym.Variable("b"),
                              name="corr")
    assert mt.sym.load_json(jsym.tojson()).list_arguments() == ["a", "b"]
    # ... and so does a JAX serving symbol ...
    from mxnet_tpu.models.transformer import transformer_lm_verify

    jserve = transformer_lm_verify(61, num_layers=1, num_heads=2,
                                   d_model=16, kv_block=4)
    tserve = mt.sym.load_json(jserve.tojson())
    assert tserve.list_arguments() == jserve.list_arguments()
    assert tserve.list_outputs() == jserve.list_outputs()
    # ... while an op name neither package registers raises, naming it
    doc = jsym.tojson().replace('"Correlation"', '"QKVPagedNoSuchOp"')
    with pytest.raises(mt.MXNetError, match="QKVPagedNoSuchOp.*not "
                                            "registered"):
        mt.sym.load_json(doc)


# ---------------------------------------------------------------------------
# model.save_checkpoint / load_checkpoint
# ---------------------------------------------------------------------------

def _params():
    rng = np.random.RandomState(4)
    arg = {"fc1_weight": rng.randn(16, 8).astype(np.float32),
           "fc1_bias": rng.randn(16).astype(np.float32)}
    aux = {"bn_moving_mean": rng.randn(16).astype(np.float32)}
    return arg, aux


def test_model_checkpoint_across_packages(tmp_path):
    arg, aux = _params()
    for saver, loader, tag in ((mt, mx, "port"), (mx, mt, "jax")):
        prefix = str(tmp_path / tag)
        arr = (lambda v: mt.nd.array(v, ctx=mt.cpu())) if saver is mt \
            else mx.nd.array
        saver.model.save_checkpoint(
            prefix, 3, W.build_sym(saver.sym),
            {k: arr(v) for k, v in arg.items()},
            {k: arr(v) for k, v in aux.items()})
        assert [f for f in os.listdir(tmp_path) if ".part." in f] == []
        sym, a2, x2 = loader.model.load_checkpoint(prefix, 3)
        assert sym.list_arguments() == W.build_sym(loader.sym
                                                   ).list_arguments()
        assert sorted(a2) == sorted(arg) and sorted(x2) == sorted(aux)
        for src, got in ((arg, a2), (aux, x2)):
            for k in src:
                np.testing.assert_array_equal(got[k].asnumpy(), src[k])


def test_load_checkpoint_errors_name_the_file(tmp_path):
    prefix = str(tmp_path / "nope")
    with pytest.raises(mt.MXNetError, match="missing symbol file.*nope"):
        mt.model.load_checkpoint(prefix, 0)
    W.build_sym().save(prefix + "-symbol.json")
    with pytest.raises(mt.MXNetError, match=r"missing params file.*0007"):
        mt.model.load_checkpoint(prefix, 7)
    arg, aux = _params()
    mx.model.save_checkpoint(prefix, 1, W.build_sym(mx.sym),
                             {k: mx.nd.array(v) for k, v in arg.items()},
                             {})
    pfile = prefix + "-0001.params"
    blob = open(pfile, "rb").read()
    with open(pfile, "wb") as f:
        f.write(blob[:len(blob) // 2])  # what a crash mid-write leaves
    with pytest.raises(mt.MXNetError, match="corrupt.*0001.params"):
        mt.model.load_checkpoint(prefix, 1)
    with open(pfile, "wb") as f:
        f.write(b"garbage not a params file")
    with pytest.raises(mt.MXNetError, match="0001.params"):
        mt.model.load_checkpoint(prefix, 1)
    with open(prefix + "-symbol.json", "w") as f:
        f.write("{ not json")
    with pytest.raises(mt.MXNetError, match="corrupt.*symbol.json"):
        mt.model.load_checkpoint(prefix, 1)


# ---------------------------------------------------------------------------
# Module checkpoints with optimizer states
# ---------------------------------------------------------------------------

OPTIMIZERS = {"sgd": {"learning_rate": 0.05, "momentum": 0.9},
              "adam": {"learning_rate": 0.01}}


def _batches(pkg, n=6, seed=3):
    X, y = W.make_data()
    rng = np.random.RandomState(seed)
    arr = (lambda v: mt.nd.array(v, ctx=mt.cpu())) if pkg is mt \
        else mx.nd.array
    out = []
    for _ in range(n):
        idx = rng.choice(len(X), W.BATCH, replace=False)
        out.append(pkg.io.DataBatch([arr(X[idx])], [arr(y[idx])]))
    return out


def _bind(mod):
    mod.bind(data_shapes=[("data", (W.BATCH, W.IN_DIM))],
             label_shapes=[("softmax_label", (W.BATCH,))])
    return mod


def _steps(mod, batches):
    for b in batches:
        mod.forward_backward(b)
        mod.update()


def _arg_numpy(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _trained(pkg, opt, tmp_path):
    """A module of ``pkg`` after 3 steps from the same Xavier parameters,
    saved with its optimizer states at epoch 3 → its prefix."""
    mx.random.seed(0)
    init = _bind(mx.mod.Module(W.build_sym(mx.sym), context=mx.cpu()))
    init.init_params(mx.initializer.Xavier(rnd_type="gaussian"))
    arg0 = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    if pkg is mt:
        mod = _bind(mt.mod.Module(W.build_sym(), context=mt.cpu()))
        mod.init_params(arg_params=mt.params_from_numpy(arg0, mt.cpu()))
    else:
        mod = init
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTIMIZERS[opt])
    _steps(mod, _batches(pkg)[:3])
    prefix = str(tmp_path / f"{pkg.__name__}-{opt}")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    return prefix


def _resumed(pkg, prefix, opt):
    """``pkg``'s ``Module.load`` of ``prefix`` epoch 3 with its optimizer
    states, then the 3 later steps → the weights."""
    mod = _bind(pkg.mod.Module.load(prefix, 3, load_optimizer_states=True,
                                    context=pkg.cpu()))
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTIMIZERS[opt])
    _steps(mod, _batches(pkg)[3:])
    return _arg_numpy(mod)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_module_states_resume_across_packages(writer, opt, fused,
                                              monkeypatch, tmp_path):
    """A ``Module.save_checkpoint(save_optimizer_states=True)`` after 3
    steps (the fused states file, or with ``MXNET_FUSED_STEP=0`` the
    ``Updater`` blob) loaded by both packages' ``Module.load(...,
    load_optimizer_states=True)``: 3 more steps on the same batches agree
    at ``GRAD``; the file unpickles to numpy and builtins only."""
    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    prefix = _trained(mt if writer == "port" else mx, opt, tmp_path)
    with open(prefix + "-0003.states", "rb") as f:
        data = pickle.load(f)
    assert_host_tree(data)
    if fused == "1":
        assert data["format"] == "mxnet_tpu-fused-states-v1"
        assert data["step"] == 3 and "fc1_weight" in data["states"]
        form = data["states"]["fc2_weight"]
    else:
        form = data[0]
    assert isinstance(form, tuple if opt == "adam" else np.ndarray)
    want = _resumed(mx, prefix, opt)
    got = _resumed(mt, prefix, opt)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD)


def assert_host_tree(obj, where="blob"):
    """Every leaf of ``obj`` a numpy array or a Python builtin."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert isinstance(k, (str, int)), f"{where}: key {k!r}"
            assert_host_tree(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            assert_host_tree(v, f"{where}[{i}]")
    else:
        assert obj is None or isinstance(
            obj, (np.ndarray, np.generic, bool, int, float, str, bytes)), \
            f"{where}: {type(obj)}"
        if isinstance(obj, bytes) and obj[:1] == b"\x80":
            assert_host_tree(pickle.loads(obj), f"{where} (pickled)")


def test_save_load_params_and_updater_states_round_trip(tmp_path):
    mod = _bind(mt.mod.Module(W.build_sym(), context=mt.cpu()))
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam")
    _steps(mod, _batches(mt)[:2])
    fname = str(tmp_path / "p.params")
    mod.save_params(fname)
    other = _bind(mt.mod.Module(W.build_sym(), context=mt.cpu()))
    other.init_params(mt.initializer.Zero())
    held = {k: v._data for k, v in other._exec.arg_dict.items()}
    other.load_params(fname)
    for k, v in _arg_numpy(mod).items():
        np.testing.assert_array_equal(other.get_params()[0][k].asnumpy(), v)
        assert other._exec.arg_dict[k]._data is held[k]  # written in place
    jmod = _bind(mx.mod.Module(W.build_sym(mx.sym), context=mx.cpu()))
    jmod.init_params(mx.initializer.Zero())
    jmod.load_params(fname)
    for k, v in _arg_numpy(mod).items():
        np.testing.assert_array_equal(jmod.get_params()[0][k].asnumpy(), v)
    upd = mt.optimizer.get_updater(mt.optimizer.create("adam"))
    w = mt.nd.array(np.ones((2, 2), np.float32), ctx=mt.cpu())
    upd(0, mt.nd.array(np.ones((2, 2), np.float32), ctx=mt.cpu()), w)
    blob = upd.get_states()
    assert_host_tree(pickle.loads(blob))
    jupd = mx.optimizer.get_updater(mx.optimizer.create("adam"))
    jupd.set_states(blob)
    back = mt.optimizer.get_updater(mt.optimizer.create("adam"))
    back.set_states(jupd.get_states())
    for a, b in zip(back.states[0], upd.states[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# bf16 optimizer states: pickles of ml_dtypes arrays, without ml_dtypes
# ---------------------------------------------------------------------------

def _bf16_module(pkg, arg0=None):
    """The crash worker's MLP bound from bfloat16 data descriptors (every
    parameter bf16), from ``arg0`` (the JAX module's seeded Xavier
    parameters when None) → (module, its start parameters)."""
    import ml_dtypes

    dt = "bfloat16" if pkg is mt else ml_dtypes.bfloat16
    sym = W.build_sym() if pkg is mt else W.build_sym(mx.sym)
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", (W.BATCH, W.IN_DIM), dt)],
             label_shapes=[pkg.io.DataDesc("softmax_label", (W.BATCH,))])
    if arg0 is None:
        mx.random.seed(0)
        if pkg is mx:
            mod.init_params(mx.initializer.Xavier(rnd_type="gaussian"))
            arg0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
            return mod, arg0
        arg0 = _bf16_module(mx)[1]
    mod.init_params(arg_params=arg0)
    return mod, arg0


def _bf16_batches(pkg, n):
    import ml_dtypes

    out = []
    for b in _batches(mt, n):
        X = b.data[0].asnumpy().astype(ml_dtypes.bfloat16)
        y = b.label[0].asnumpy()
        arr = (lambda v: mt.nd.array(v, ctx=mt.cpu())) if pkg is mt \
            else mx.nd.array
        out.append(pkg.io.DataBatch([arr(X)], [arr(y)]))
    return out


def _state_leaves(blob, fused):
    """The arrays of a states file by (name or index, slot), read with
    the port's reader: HostBF16 for bf16."""
    data = mt.checkpoint.loads(blob)
    trees = data["states"] if fused == "1" else data
    out = {}
    for k, tree in trees.items():
        for i, leaf in enumerate(tree if isinstance(tree, tuple)
                                 else (tree,)):
            out[(k, i)] = leaf
    return out


def _leaf_bits(leaf):
    """The raw bits of a state array: a HostBF16's, or a numpy
    array's."""
    if isinstance(leaf, mt.ndarray.HostBF16):
        return leaf.bits
    return np.asarray(leaf).view(np.uint8)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_optimizer_states_resume_across_packages(writer, opt, fused,
                                                      monkeypatch,
                                                      tmp_path):
    """A bf16 module's optimizer states after 3 steps (the fused states
    file, or with ``MXNET_FUSED_STEP=0`` the ``Updater`` blob), written
    by either package: the pickle holds ``ml_dtypes.bfloat16`` arrays
    (plain ``pickle`` with ml_dtypes reads them as such); a module of
    each package loads the file, saves its states again before any step
    and they are the writer's bit for bit; then each takes a step with
    finite outputs and bf16 states.  The JAX package's eager Adam
    (``Updater``) alone writes float32 states: its float32 bias
    correction widens a bf16 weight and its moments (the port keeps
    them bf16 on both paths, as the JAX fused step does)."""
    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    src = mt if writer == "port" else mx
    mod, arg0 = _bf16_module(src)
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTIMIZERS[opt])
    _steps(mod, _bf16_batches(src, 3))
    fname = str(tmp_path / "bf16.states")
    mod.save_optimizer_states(fname)
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    with open(fname, "rb") as f:
        blob = f.read()
    plain = pickle.loads(blob)
    tree = plain["states"]["fc1_weight"] if fused == "1" else plain[0]
    leaf = tree[0] if isinstance(tree, tuple) else tree
    widened = writer == "jax" and fused == "0" and opt == "adam"
    assert leaf.dtype.name == ("float32" if widened else "bfloat16")
    want = _state_leaves(blob, fused)
    assert want and all(isinstance(v, mt.ndarray.HostBF16) != widened
                        for v in want.values())
    for pkg in (mx, mt):
        other, _ = _bf16_module(pkg, params)
        other.init_optimizer(optimizer=opt, optimizer_params=OPTIMIZERS[opt])
        other.load_optimizer_states(fname)
        again = str(tmp_path / f"again-{pkg.__name__}.states")
        other.save_optimizer_states(again)
        with open(again, "rb") as f:
            got = _state_leaves(f.read(), fused)
        assert sorted(got, key=str) == sorted(want, key=str)
        for k in want:
            np.testing.assert_array_equal(_leaf_bits(got[k]),
                                          _leaf_bits(want[k]),
                                          err_msg=f"{pkg.__name__} {k}")
        _steps(other, _bf16_batches(pkg, 4)[3:])
        out = other.get_outputs()[0].asnumpy().astype(np.float32)
        assert np.isfinite(out).all()
    if fused == "1":
        assert all(s.dtype == torch.bfloat16 for tree in
                   other._fused.states.values() for s in
                   (tree if isinstance(tree, tuple) else (tree,)))


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # the card's machine: no ml_dtypes
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests")
import mxnet_tpu_torch as mt
import torch_ckpt_crash_worker as W
fname, params, out = sys.argv[2], sys.argv[3], sys.argv[4]
arg = {k: torch.from_numpy(v).view(torch.bfloat16)
       for k, v in np.load(params).items()}
mod = mt.mod.Module(W.build_sym(), context=mt.cpu())
mod.bind(data_shapes=[mt.io.DataDesc("data", (W.BATCH, W.IN_DIM),
                                     "bfloat16")],
         label_shapes=[mt.io.DataDesc("softmax_label", (W.BATCH,))])
mod.init_params(arg_params=arg)
mod.init_optimizer(optimizer="adam", optimizer_params={"learning_rate": 0.01})
mod.load_optimizer_states(fname)
X, y = W.make_data()
batch = mt.io.DataBatch(
    [mt.nd.array(torch.from_numpy(X[:W.BATCH]).to(torch.bfloat16),
                 ctx=mt.cpu())],
    [mt.nd.array(y[:W.BATCH], ctx=mt.cpu())])
mod.forward_backward(batch)
mod.update()
mod.save_optimizer_states(out)
print("ml_dtypes" in sys.modules and sys.modules["ml_dtypes"] is not None)
"""


def test_bf16_states_read_and_written_without_ml_dtypes(monkeypatch,
                                                        tmp_path):
    """The port's reader and writer in a process where ``ml_dtypes``
    cannot be imported (``sys.modules["ml_dtypes"] = None``, as on the
    card's machine): it loads the JAX package's bf16 fused states file
    into a bf16 module, steps and writes its own, which the JAX package
    (here, with ml_dtypes) loads: ``ml_dtypes.bfloat16`` moments that
    have moved from the JAX file's."""
    import subprocess

    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    mod, _ = _bf16_module(mx)
    mod.init_optimizer(optimizer="adam", optimizer_params=OPTIMIZERS["adam"])
    _steps(mod, _bf16_batches(mx, 2))
    fname, out = str(tmp_path / "jax.states"), str(tmp_path / "port.states")
    mod.save_optimizer_states(fname)
    params = str(tmp_path / "params.npz")
    np.savez(params, **{k: v.asnumpy().view(np.int16)
                        for k, v in mod.get_params()[0].items()})
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, REPO, fname,
                           params, out], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
    with open(fname, "rb") as f:
        before = pickle.load(f)["states"]
    with open(out, "rb") as f:
        after = pickle.load(f)
    assert after["step"] == 3
    for n, (m, v) in before.items():
        m2, v2 = after["states"][n]
        assert m2.dtype.name == v2.dtype.name == "bfloat16"
        assert m2.shape == m.shape and not np.array_equal(
            m2.view(np.int16), m.view(np.int16)), n
    jmod, _ = _bf16_module(mx, {k: v.asnumpy() for k, v in
                                mod.get_params()[0].items()})
    jmod.init_optimizer(optimizer="adam", optimizer_params=OPTIMIZERS["adam"])
    jmod.load_optimizer_states(out)
    _steps(jmod, _bf16_batches(mx, 1))
    assert np.isfinite(jmod.get_outputs()[0].asnumpy().astype(
        np.float32)).all()


def test_examples_model_prefix_and_load_epoch(tmp_path):
    """``train_imagenet --model-prefix`` checkpoints each epoch (the
    loaded arrays, BatchNorm statistics included, equal the module's);
    ``--load-epoch`` starts from that checkpoint at that epoch."""
    from mxnet_tpu_torch.examples import train_imagenet

    prefix = str(tmp_path / "r20")
    argv = ["--benchmark", "1", "--network", "resnet-20", "--image-shape",
            "3,32,32", "--num-classes", "10", "--batch-size", "4",
            "--num-batches", "2", "--model-prefix", prefix]
    mod = train_imagenet.main(argv + ["--num-epochs", "1"], ctx=mt.cpu())
    _, arg, aux = mt.model.load_checkpoint(prefix, 1)
    have_arg, have_aux = mod.get_params()
    assert sorted(aux) == sorted(have_aux) and aux
    for src, have in ((arg, have_arg), (aux, have_aux)):
        for k, v in src.items():
            np.testing.assert_array_equal(v.asnumpy(), have[k].asnumpy())
    seen = []
    orig = mt.mod.Module.fit

    def spy(self, *a, **kw):
        seen.append(kw["begin_epoch"])
        return orig(self, *a, **kw)

    mt.mod.Module.fit = spy
    try:
        mod2 = train_imagenet.main(argv + ["--num-epochs", "2",
                                           "--load-epoch", "1"],
                                   ctx=mt.cpu())
    finally:
        mt.mod.Module.fit = orig
    assert seen == [1]
    assert os.path.exists(prefix + "-0002.params")
    assert all(np.isfinite(v.asnumpy()).all()
               for v in mod2.get_params()[0].values())
