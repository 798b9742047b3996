"""The port's ten serving operators against the JAX package's on the CPU,
each through its registry's ``invoke`` on the same inputs.

Pools hold stale random values (and, quantized, valid stale codes) that
the masks must keep out; block tables are fragmented; ``start`` and
``lengths`` differ between rows, with padded rows (``lengths`` 0, or
window rows past ``lengths``).  Tolerances as
``tests/test_torch_suffix_prefill.py``'s docstring: outputs at
rtol = atol = 1e-5 on the real rows (padding rows are garbage in both
packages), fp32 pools at rtol 1e-6 past the scratch page 0 (whose
duplicate writes either package may order), int8/fp8 codes at most one
code apart in at most 1% of the slots.  The port writes the pools in
place and returns those tensors as its ``new_*`` outputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_torch_spec import _quant_pools
from torch_serving_parity import pool_bytes

torch.set_num_threads(1)

KVB, H, D, P, MB = 4, 2, 16, 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)
# three streams over fragmented pages
TABLE = np.array([[7, 2, 11, 5], [9, 3, 14, 1], [4, 12, 6, 10]], np.int32)
QUANT = ("int8", "fp8")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(name, rng):
    """Stale pools: (JAX arrays, port tensors); [k, v] or, quantized,
    [k, v, k_scale, v_scale]."""
    kp = rng.randn(P, KVB, H, D).astype(np.float32)
    vp = rng.randn(P, KVB, H, D).astype(np.float32)
    if name == "fp32":
        return [jnp.asarray(kp), jnp.asarray(vp)], [_t(kp), _t(vp)]
    j, t = _quant_pools(name, kp, vp)
    return list(j), t


def _run(op, j_in, t_in, attrs=None):
    """Both packages' op on the same inputs → (JAX outputs, port
    outputs)."""
    jouts, _ = jreg.invoke(op, [jnp.asarray(x) if isinstance(x, np.ndarray)
                                else x for x in j_in], attrs or {})
    touts, _ = treg.invoke(op, [_t(x) if isinstance(x, np.ndarray) else x
                                for x in t_in], attrs or {})
    return jouts, touts


def _check_pools(jpools, tpools, tol=dict(rtol=1e-6, atol=0)):
    """fp32 pools within ``tol`` (a model's K/V, computed by each package
    through its own matmuls: the outputs' tolerance), quantized codes
    within one code in at most 1% of the slots; page 0 left out."""
    for jp, tp in zip(jpools, tpools):
        if tp.dtype == torch.float32:
            np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                       **tol)
            continue
        a = pool_bytes(tp)[1:].astype(np.int32)
        b = pool_bytes(jp)[1:].astype(np.int32)
        if tp.dtype == torch.int8:
            a, b = tp.numpy()[1:].astype(np.int32), np.asarray(jp)[1:] \
                .astype(np.int32)
            assert np.abs(a - b).max() <= 1
        assert (a != b).mean() <= 0.01


def _same_tensors(touts, tpools):
    """The new_* outputs are the pools the port wrote in place."""
    assert all(o is p for o, p in zip(touts, tpools))


def test_qkv_self_attention_prefill():
    rng = np.random.RandomState(1)
    qkv = rng.randn(2, 9, 3 * H * D).astype(np.float32)
    jo, to = _run("QKVSelfAttentionPrefill", [qkv], [qkv],
                  {"num_heads": H, "block_size": KVB})
    assert [tuple(o.shape) for o in to] == [(2, 9, H * D), (2, 9, H, D),
                                            (2, 9, H, D)]
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_qkv_self_attention_decode_contiguous():
    """The contiguous-cache decode (B8 with ``kv_len = lengths``): per-row
    lengths, a padded row (lengths 0), stale cache rows past each
    length."""
    rng = np.random.RandomState(2)
    C = 12
    qkv = rng.randn(3, 1, 3 * H * D).astype(np.float32)
    ck = rng.randn(3, C, H, D).astype(np.float32)
    cv = rng.randn(3, C, H, D).astype(np.float32)
    lengths = np.array([5, 0, C], np.int32)
    tk, tv = _t(ck), _t(cv)
    jo, to = _run("QKVSelfAttentionDecode", [qkv, ck, cv, lengths],
                  [qkv, tk, tv, lengths],
                  {"num_heads": H, "block_size": KVB})
    _same_tensors(to[1:], [tk, tv])
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **TOL)
    for a, b in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("name", ["fp32", *QUANT])
def test_qkv_paged_attention_decode(name):
    rng = np.random.RandomState(3)
    jp, tp = _pools(name, rng)
    qkv = rng.randn(3, 1, 3 * H * D).astype(np.float32)
    lengths = np.array([5, 0, 9], np.int32)
    op = "QKVPagedAttentionDecode" + ("" if name == "fp32" else "Q")
    jo, to = _run(op, [qkv, *jp, TABLE, lengths], [qkv, *tp, TABLE, lengths],
                  {"num_heads": H})
    _same_tensors(to[1:], tp)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **TOL)
    _check_pools(jo[1:], to[1:])


@pytest.mark.parametrize("name", ["fp32", *QUANT])
def test_paged_cache_write(name):
    rng = np.random.RandomState(4)
    jp, tp = _pools(name, rng)
    k = rng.randn(3, 6, H, D).astype(np.float32)
    v = rng.randn(3, 6, H, D).astype(np.float32)
    lengths = np.array([6, 3, 0], np.int32)
    op = "PagedCacheWrite" + ("" if name == "fp32" else "Q")
    jo, to = _run(op, [k, v, *jp, TABLE, lengths], [k, v, *tp, TABLE,
                                                    lengths])
    _same_tensors(to, tp)
    _check_pools(jo, to)


@pytest.mark.parametrize("name", ["fp32", *QUANT])
def test_qkv_paged_prefill_attend_per_row_start(name):
    """The suffix prefill with ``start`` a (B,) tensor that differs
    between rows (0: a first chunk, one page, two pages) and a suffix
    padded to its bucket in every row; the table's MB pages are gathered
    at a fixed width, stale past ``start``."""
    rng = np.random.RandomState(5)
    jp, tp = _pools(name, rng)
    Ts = 4
    qkv = rng.randn(3, Ts, 3 * H * D).astype(np.float32)
    start = np.array([KVB, 0, 2 * KVB], np.int32)
    real = np.array([3, 4, 2], np.int32)
    lengths = start + real
    op = "QKVPagedPrefillAttend" + ("" if name == "fp32" else "Q")
    args = [TABLE, start, lengths]
    jo, to = _run(op, [qkv, *jp, *args], [qkv, *tp, *args],
                  {"num_heads": H})
    _same_tensors(to[1:], tp)
    for b in range(3):
        np.testing.assert_allclose(to[0].numpy()[b, :real[b]],
                                   np.asarray(jo[0])[b, :real[b]], **TOL)
    _check_pools(jo[1:], to[1:])


@pytest.mark.parametrize("name", ["fp32", *QUANT])
def test_qkv_paged_verify_attend(name):
    """A verify window of 3 rows at per-row starts, the last rows of two
    streams padding (past ``lengths``)."""
    rng = np.random.RandomState(6)
    jp, tp = _pools(name, rng)
    W = 3
    qkv = rng.randn(3, W, 3 * H * D).astype(np.float32)
    start = np.array([KVB, 0, 7], np.int32)
    live = np.array([3, 1, 2], np.int32)
    args = [TABLE, start, start + live]
    op = "QKVPagedVerifyAttend" + ("" if name == "fp32" else "Q")
    jo, to = _run(op, [qkv, *jp, *args], [qkv, *tp, *args],
                  {"num_heads": H})
    _same_tensors(to[1:], tp)
    for b in range(3):
        np.testing.assert_allclose(to[0].numpy()[b, :live[b]],
                                   np.asarray(jo[0])[b, :live[b]], **TOL)
    _check_pools(jo[1:], to[1:])


@pytest.mark.parametrize("op", sorted(
    ["QKVSelfAttentionPrefill", "QKVSelfAttentionDecode",
     "QKVPagedAttentionDecode", "QKVPagedAttentionDecodeQ",
     "QKVPagedPrefillAttend", "QKVPagedPrefillAttendQ",
     "QKVPagedVerifyAttend", "QKVPagedVerifyAttendQ", "PagedCacheWrite",
     "PagedCacheWriteQ"]))
def test_serving_op_interface_equals_jax(op):
    """Argument names, output names and ``infer_shape`` as the JAX op's."""
    j, t = jreg.get_op(op), treg.get_op(op)
    attrs = {"num_heads": str(H)}
    assert t.input_names(attrs) == j.input_names(attrs)
    assert t.output_names(attrs) == j.output_names(attrs)
    B, T = 3, 4 if "Decode" not in op else 1
    shapes = {"qkv": (B, T, 3 * H * D), "key": (B, T, H, D),
              "value": (B, T, H, D), "k_pool": (P, KVB, H, D),
              "v_pool": (P, KVB, H, D), "k_scale": (P, KVB, H),
              "v_scale": (P, KVB, H), "block_table": (B, MB),
              "lengths": (B,), "start": (B,), "cache_k": (B, 12, H, D),
              "cache_v": (B, 12, H, D)}
    ins = [shapes[n] for n in j.input_names(attrs)]
    assert t.infer_shape(attrs, list(ins))[1] \
        == j.infer_shape(attrs, list(ins))[1]
