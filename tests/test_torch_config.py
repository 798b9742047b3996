"""The port's catalog of environment variables (``mxnet_tpu_torch/
config.py``) and its engine control (``engine.py``), on the CPU.

Lint, as ``tests/test_env_catalog.py`` does over ``mxnet_tpu/``: every
``MXNET_*`` variable mentioned in ``mxnet_tpu_torch/`` resolves through
the catalog (a read exactly, prose by family prefix), and every entry
is mentioned outside ``config.py`` (no dead entries).  Each variable the
JAX package also declares has its type and default.  ``engine``: the JAX
package's names,
``NaiveEngine`` synchronizing executor runs and training steps."""

import os
import re

import numpy as np
import pytest

import mxnet_tpu.config as jax_config
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, engine

_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mxnet_tpu_torch")
_TOKEN = re.compile(r"MXNET_[A-Z0-9_]+")
_READ = re.compile(r"environ|get_env|getenv|_env_int|_env_buckets|"
                   r"_env\(|describe\(")


def _catalog():
    return {v.name for v in config.list_env()}


def _sources():
    for root, _dirs, files in os.walk(_PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)


def test_every_env_read_resolves_through_the_catalog():
    registered = _catalog()
    offenders = []
    for path in _sources():
        rel = os.path.relpath(path, os.path.dirname(_PKG))
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                for tok in _TOKEN.findall(line):
                    name = tok.rstrip("_")
                    if name in registered:
                        continue
                    if _READ.search(line):
                        offenders.append(f"{rel}:{lineno}: {tok} (read)")
                    elif not any(r.startswith(name + "_")
                                 for r in registered):
                        offenders.append(f"{rel}:{lineno}: {tok} (mention)")
    assert not offenders, ("MXNET_* variables outside the catalog:\n  "
                           + "\n  ".join(offenders))


def test_catalog_has_no_dead_entries():
    mentioned = set()
    for path in _sources():
        if os.path.basename(path) != "config.py":
            with open(path) as f:
                mentioned.update(_TOKEN.findall(f.read()))
    dead = sorted(_catalog() - mentioned)
    assert not dead, f"catalog entries the port never reads: {dead}"


@pytest.mark.parametrize("name", sorted(
    {v.name for v in config.list_env()}
    & {v.name for v in jax_config.list_env()}))
def test_shared_variables_keep_the_jax_type_and_default(name):
    mine, theirs = config.describe(name), jax_config.describe(name)
    assert mine.dtype is theirs.dtype
    assert mine.default == theirs.default
    assert mine.doc


def test_checkpoint_variables_moved_into_the_catalog(monkeypatch):
    from mxnet_tpu_torch import checkpoint

    assert not hasattr(checkpoint, "_ENV")
    names = [v.name for v in config.list_env()
             if v.name.startswith("MXNET_CKPT_")]
    assert len(names) == 6
    assert checkpoint._env("MXNET_CKPT_KEEP") == 5
    monkeypatch.setenv("MXNET_CKPT_KEEP", "banana")
    with pytest.raises(mt.MXNetError, match="MXNET_CKPT_KEEP"):
        checkpoint._env("MXNET_CKPT_KEEP")


def test_list_describe_and_current(monkeypatch):
    names = [v.name for v in config.list_env()]
    assert names == sorted(names)
    assert "MXNET_BACKWARD_DO_MIRROR" in names
    with pytest.raises(KeyError, match="not a declared"):
        config.describe("MXNET_NO_SUCH_VARIABLE")
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    cur = config.current()
    assert cur["MXNET_BACKWARD_DO_MIRROR"] == 1
    assert cur["MXNET_FUSED_STEP"] == os.environ.get("MXNET_FUSED_STEP",
                                                     "1")
    assert mt.config is config and mt.engine is engine


def test_engine_names_as_jax():
    import mxnet_tpu.engine as jax_engine

    for name in ("set_engine_type", "engine_type", "is_naive",
                 "sync_if_naive", "push", "wait_for_var", "wait_all"):
        assert callable(getattr(engine, name))
        assert callable(getattr(jax_engine, name))
    assert engine.DEFAULT_ENGINE_TYPE == jax_engine.DEFAULT_ENGINE_TYPE
    with pytest.raises(mt.MXNetError, match="unknown engine type"):
        engine.set_engine_type("FastEngine")


def test_naive_engine_synchronizes_each_run(monkeypatch):
    """Under NaiveEngine every executor forward, backward and fused
    training step calls ``sync_if_naive`` on what it made."""
    seen = []
    real = engine.sync_if_naive
    monkeypatch.setattr(engine, "sync_if_naive",
                        lambda arrays: seen.append(len(list(arrays)))
                        or real(arrays))
    old = engine.engine_type()
    engine.set_engine_type("NaiveEngine")
    try:
        assert engine.is_naive()
        net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=2, name="fc"),
            name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(data_shapes=[("data", (4, 3))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        mod.init_optimizer()
        batch = mt.io.DataBatch([mt.nd.ones((4, 3), ctx=mt.cpu())],
                                [mt.nd.zeros((4,), ctx=mt.cpu())])
        mod.forward_backward(batch)
        mod.update()  # the fused step
        mod.forward(batch, is_train=False)  # the executor's forward
        assert len(seen) == 2
        ran = []
        engine.push(lambda: ran.append(1), read_arrays=[batch.data[0]])
        engine.wait_all()
        assert ran == [1]
    finally:
        engine.set_engine_type(old)
    assert not engine.is_naive() or old == "NaiveEngine"


def test_num_devices():
    import torch

    assert mt.context.num_devices("cpu") == 1
    want = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert mt.context.num_devices() == want
    with pytest.raises(mt.MXNetError, match="unknown device type"):
        mt.context.num_devices("tpu")
    assert np.isscalar(mt.context.num_devices("gpu"))
