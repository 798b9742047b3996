"""The port at head widths other than 64, against the JAX package.

``transformer_lm`` at its own defaults (4 layers, 4 heads, d_model 128:
heads 32 lanes wide) and at 128-lane heads (2 heads over d_model 256)
goes through every kernel wrapper of the packed and paged paths: B1's
forward and backward in training, B1 and the paged decode in serving.
The JAX package sends every head width to its kernels; the port's CUDA
kernels take head widths up to 128 in buckets of 32, 64, 96 and 128
lanes (``cuda_kernels.HEAD_DIM_BUCKETS``), and on the CPU the wrappers
run their plain versions, which these tests hold against the JAX
package on its own CPU route.  Parameters come from a JAX ``Module``
(``get_params``) and cross through ``params_from_numpy``.

Tolerances (fp32), as ``test_torch_module.py`` and
``test_torch_serving.py``: outputs rtol=atol=1e-5, weights after one SGD
step rtol=atol=5e-5; greedy chains token for token up to the first
position where the JAX full forward's top-2 margin is within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.executor import build_graph_fn
from mxnet_tpu.models import transformer_lm as jax_transformer_lm
from mxnet_tpu.models.transformer import transformer_lm_prefill
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import cuda_kernels as ck

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

V, T, B, KVB = 61, 32, 2, 4
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
MARGIN = 1e-4
# (num_layers, num_heads, d_model): transformer_lm's defaults (head width
# 32), and 128-lane heads
WIDTHS = {32: (4, 4, 128), 128: (2, 2, 256)}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def lm(request):
    """(head width, architecture, host parameters from a JAX Module)."""
    L, NH, DM = WIDTHS[request.param]
    assert DM // NH == request.param <= ck.FLASH_MHA_MAX_HEAD_DIM
    jmod = mx.mod.Module(jax_transformer_lm(V, T, num_layers=L, num_heads=NH,
                                            d_model=DM, head="ce"),
                         context=mx.cpu())
    jmod.bind(data_shapes=[("data", (B, T))],
              label_shapes=[("softmax_label", (B, T))])
    jmod.init_params(mx.initializer.Xavier(magnitude=2.0))
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    # learned positions start at zero; give them values
    host["pos_embed_weight"] = (np.random.RandomState(5).randn(T, DM)
                                * 0.1).astype(np.float32)
    return request.param, dict(num_layers=L, num_heads=NH, d_model=DM), host


def test_default_lm_is_32_lanes_a_head():
    """The repo's default ``transformer_lm`` has heads of width 32, a
    bucket the kernels are instantiated for."""
    import inspect

    sig = inspect.signature(mt.models.transformer_lm).parameters
    width = sig["d_model"].default // sig["num_heads"].default
    assert WIDTHS[width][1:] == (sig["num_heads"].default,
                                 sig["d_model"].default)
    assert width in ck.HEAD_DIM_BUCKETS


def test_module_step_matches_jax(lm):
    """One SGD step through ``Module`` (forward, the attention backward,
    update) in both packages on the same weights and batch: the per-token
    losses and every updated weight agree."""
    _, arch, host = lm
    shapes = dict(data_shapes=[("data", (B, T))],
                  label_shapes=[("softmax_label", (B, T))])
    opt = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    jmod = mx.mod.Module(jax_transformer_lm(V, T, head="ce", **arch),
                         context=mx.cpu())
    jmod.bind(**shapes)
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in host.items()})
    jmod.init_optimizer(**opt)
    tmod = mt.mod.Module(mt.models.transformer_lm(V, T, head="ce", **arch),
                         context=mt.cpu())
    tmod.bind(**shapes)
    tmod.init_params(arg_params=host)
    tmod.init_optimizer(**opt)

    rng = np.random.RandomState(3)
    X = rng.randint(1, V, (B, T)).astype(np.float32)
    Y = rng.randint(0, V, (B, T)).astype(np.float32)  # 0s are ignored
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(Y)]))
    jmod.update()
    ck.reset_launch_counts()
    tmod.forward_backward(mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                          [mt.nd.array(Y, ctx=mt.cpu())]))
    tmod.update()
    assert not any(ck.LAUNCHES.values())  # the CPU runs plain versions
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(), **FWD)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    assert sorted(tw) == sorted(jw)
    for k in tw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **GRAD)
    # the step moved every attention weight
    for i in range(arch["num_layers"]):
        n = f"layer{i}_qkv_weight"
        assert np.abs(tw[n] - host[n]).max() > 1e-4, n


def test_greedy_decode_matches_jax_engine(lm):
    """Two requests of 3 and 9 prompt tokens and 8 and 6 new tokens through
    both packages' ``DecodeEngine`` (prefill, then paged decode steps):
    the greedy chains agree, and the port's full forward gives the JAX
    full forward's logits."""
    _, arch, host = lm
    L = arch["num_layers"]
    rng = np.random.RandomState(11)
    jobs = [(rng.randint(1, V, size=n).astype(np.int32), m)
            for n, m in ((3, 8), (9, 6))]
    kw = dict(vocab_size=V, max_len=T, kv_block=KVB, max_streams=2,
              decode_buckets=[1, 2], temperature=0.0, **arch)

    def serve(engine_cls, params, **over):
        with engine_cls(params, **kw, **over) as eng:
            futs = [eng.submit(p, n) for p, n in jobs]
            return ([np.asarray(f.result(timeout=300)) for f in futs],
                    eng.stats())

    j_outs, _ = serve(mx.DecodeEngine, host, prefix_cache=0)
    t_outs, st = serve(mt.DecodeEngine, mt.params_from_numpy(host, "cpu"),
                       ctx=mt.cpu())
    assert st["prefills"] == len(jobs) and st["steps"] > 0

    s = transformer_lm_prefill(V, num_layers=L,
                               num_heads=arch["num_heads"],
                               d_model=arch["d_model"], kv_block=KVB,
                               paged=False)
    gfn = build_graph_fn(s)
    base = {n: jnp.asarray(host[n]) for n in s.list_arguments() if n in host}
    port = mt.models.transformer.TransformerLM(
        mt.params_from_numpy(host, "cpu"), num_layers=L,
        num_heads=arch["num_heads"], kv_block=KVB)
    compared = 0
    for (prompt, _), jo, to in zip(jobs, j_outs, t_outs):
        assert len(jo) == len(to)
        seq = np.concatenate([prompt, jo]).astype(np.int32)
        a = dict(base, data=jnp.asarray(seq[None]),
                 positions=jnp.asarray(np.arange(len(seq),
                                                 dtype=np.int32)[None]),
                 lengths=jnp.asarray(np.asarray([len(seq)], np.int32)))
        jl = np.asarray(gfn(a, {}, jax.random.PRNGKey(0), False)[0][0][0])
        tl = port(torch.from_numpy(seq)[None].long())[0].numpy()
        np.testing.assert_allclose(tl, jl, **FWD)
        for i in range(len(jo)):
            top2 = np.sort(jl[len(prompt) + i - 1])[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break  # a near-tie: later tokens condition on it
            assert to[i] == jo[i], (prompt, i, jo, to)
            compared += 1
    assert compared * 2 >= sum(len(jo) for jo in j_outs)
