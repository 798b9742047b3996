"""The port's attention kernels (plain versions, on the CPU) against the
JAX package: the Pallas kernels in interpret mode and the lax paths.

fp32 tolerance rtol=atol=1e-5: both sides compute the same function, but
the Pallas tile is never below 128 keys while the lax path and the
port's plain versions use the given block, so the online softmax
partitions and sums the keys in other orders (agreement ~1e-6, not
bitwise).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.attention import paged_decode_attention
from mxnet_tpu.ops.registry import invoke
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
KVB = 4


def _lse_ref(qkv, H, causal):
    """float64 numpy log-sum-exp of each row's scaled scores (B, T, H)."""
    B, T, HD3 = qkv.shape
    D = HD3 // (3 * H)
    q, k, _ = (x.reshape(B, T, H, D).astype(np.float64)
               for x in np.split(qkv, 3, axis=-1))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    mx_ = s.max(-1, keepdims=True)
    lse = np.log(np.exp(s - mx_).sum(-1)) + mx_[..., 0]
    return lse.transpose(0, 2, 1)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_packed_plain_vs_pallas_and_lax(monkeypatch, causal):
    # T = 37 is a multiple of neither the plain block (16) nor the
    # Pallas tile (128)
    B, T, H, D = 2, 37, 2, 16
    qkv = np.random.RandomState(0).randn(B, T, 3 * H * D).astype(np.float32)
    out, lse = ck.flash_mha_packed(torch.from_numpy(qkv), H, causal=causal,
                                   block_size=16)
    assert out.shape == (B, T, H * D) and lse.shape == (B, T, H)

    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert pk.enabled()
    pallas = np.asarray(pk.flash_mha_packed(jnp.asarray(qkv), H,
                                            causal=causal, block_size=128))
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)

    monkeypatch.setenv("MXNET_PALLAS", "0")
    if causal:  # the prefill op of the serving path
        (lax, _, _), _ = invoke("QKVSelfAttentionPrefill",
                                [jnp.asarray(qkv)],
                                {"num_heads": H, "block_size": 16})
    else:
        (lax,), _ = invoke("QKVSelfAttention", [jnp.asarray(qkv)],
                           {"num_heads": H, "causal": False,
                            "block_size": 16})
    np.testing.assert_allclose(out.numpy(), np.asarray(lax), **TOL)
    # lse is the port's own output (natural log, (B, T, H)); only o
    # crosses packages, lse is held against float64 numpy
    np.testing.assert_allclose(lse.numpy(), _lse_ref(qkv, H, causal),
                               **TOL)


def test_qkv_prefill_returns_kv_views_of_packed_input():
    B, T, H, D = 1, 8, 2, 4
    qkv = torch.from_numpy(
        np.random.RandomState(1).randn(B, T, 3 * H * D).astype(np.float32))
    out, k, v = tatt.qkv_self_attention_prefill(qkv, H, block_size=KVB)
    np.testing.assert_array_equal(
        k.numpy(), qkv[..., H * D:2 * H * D].reshape(B, T, H, D).numpy())
    np.testing.assert_array_equal(
        v.numpy(), qkv[..., 2 * H * D:].reshape(B, T, H, D).numpy())
    assert out.shape == (B, T, H * D)


def _paged_case(seed=3):
    rng = np.random.RandomState(seed)
    B, H, D, P, MB = 4, 2, 8, 10, 3
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(P, KVB, H, D).astype(np.float32)
    vp = rng.randn(P, KVB, H, D).astype(np.float32)
    # fragmented tables; row 2 is an empty slot (lengths 0, all page 0);
    # row 3 ends exactly on a page boundary (8 = 2 pages of 4)
    table = np.array([[5, 2, 9], [1, 7, 3], [0, 0, 0], [8, 4, 0]],
                     np.int32)
    lengths = np.array([9, 5, 0, 8], np.int32)
    return q, kp, vp, table, lengths


def test_paged_attention_decode_plain_vs_pallas_and_lax(monkeypatch):
    q, kp, vp, table, lengths = _paged_case()
    out = ck.paged_attention_decode(
        *(torch.from_numpy(x) for x in (q, kp, vp, table, lengths))).numpy()

    monkeypatch.setenv("MXNET_PALLAS", "1")
    pallas = np.asarray(pk.paged_attention_decode(
        *(jnp.asarray(x) for x in (q, kp, vp, table, lengths))))
    np.testing.assert_allclose(out, pallas, **TOL)

    monkeypatch.setenv("MXNET_PALLAS", "0")
    lax = np.asarray(paged_decode_attention(
        jnp.asarray(q[:, None]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths)))[:, 0]
    np.testing.assert_allclose(out, lax, **TOL)

    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[2], np.zeros_like(out[2]))


def test_paged_decode_ignores_pages_past_length():
    """Garbage past a stream's length (in its last page and in the
    table's padding) does not reach the output."""
    q, kp, vp, table, lengths = _paged_case(seed=5)
    ref = ck.paged_attention_decode(
        *(torch.from_numpy(x) for x in (q, kp, vp, table, lengths)))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = vp2[0] = 1e4           # the scratch page
    kp2[9, 1:] = vp2[9, 1:] = -1e4  # row 0's last page, slots >= 1
    table2 = table.copy()
    table2[1, 2] = 6                # row 1 holds 2 pages; col 2 padding
    got = ck.paged_attention_decode(
        *(torch.from_numpy(x) for x in (q, kp2, vp2, table2, lengths)))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_qkv_paged_decode_pool_writes_match_registry(monkeypatch):
    rng = np.random.RandomState(4)
    B, H, D, P = 3, 2, 8, 8
    qkv = rng.randn(B, 1, 3 * H * D).astype(np.float32)
    kp = rng.randn(P, KVB, H, D).astype(np.float32)
    vp = rng.randn(P, KVB, H, D).astype(np.float32)
    table = np.array([[3, 6], [1, 4], [0, 0]], np.int32)
    lengths = np.array([6, 3, 0], np.int32)
    monkeypatch.setenv("MXNET_PALLAS", "0")
    (o_j, k_j, v_j), _ = invoke(
        "QKVPagedAttentionDecode",
        [jnp.asarray(x) for x in (qkv, kp, vp, table, lengths)],
        {"num_heads": H})
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    o_t, k_t, v_t = tatt.qkv_paged_attention_decode(
        torch.from_numpy(qkv), kt, vt, torch.from_numpy(table),
        torch.from_numpy(lengths), H)
    assert k_t is kt and v_t is vt  # written in place
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)


def test_paged_prefill_write_matches_registry():
    rng = np.random.RandomState(6)
    B, T, H, D, P = 2, 8, 2, 4, 9
    k = rng.randn(B, T, H, D).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32)
    kp = np.zeros((P, KVB, H, D), np.float32)
    table = np.array([[7, 2], [5, 0]], np.int32)
    lengths = np.array([6, 3], np.int32)
    (k_j, v_j), _ = invoke(
        "PagedCacheWrite",
        [jnp.asarray(x) for x in (k, v, kp, kp, table, lengths)], {})
    k_t, v_t = tatt.paged_prefill_write(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kp.copy()),
        torch.from_numpy(kp.copy()), torch.from_numpy(table),
        torch.from_numpy(lengths))
    # page 0 takes every padding row; which duplicate lands there is
    # left to each scatter, and no read ever sees it unmasked
    np.testing.assert_array_equal(k_t.numpy()[1:], np.asarray(k_j)[1:])
    np.testing.assert_array_equal(v_t.numpy()[1:], np.asarray(v_j)[1:])


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor reaches the plain version: any other device
    launches a kernel or raises (here: the meta device, no kernel)."""
    qkv = torch.empty((1, 8, 3 * 2 * 32), device="meta")
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        ck.flash_mha_packed(qkv, 2, causal=True)
    q = torch.empty((1, 2, 32), device="meta")
    pool = torch.empty((3, KVB, 2, 32), device="meta")
    ids = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        ck.paged_attention_decode(q, pool, pool, ids,
                                  torch.zeros(1, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(MXNetError, match="several devices"):
        ck.paged_attention_decode(torch.zeros(1, 2, 32), pool, pool, ids,
                                  torch.zeros(1, dtype=torch.int32))


def test_qkv_packing_is_validated():
    with pytest.raises(MXNetError, match="does not pack"):
        ck.flash_mha_packed(torch.zeros(1, 4, 10), 2)
    with pytest.raises(MXNetError, match="ONE query position"):
        tatt.qkv_paged_attention_decode(
            torch.zeros(1, 2, 12), torch.zeros(2, KVB, 2, 2),
            torch.zeros(2, KVB, 2, 2), torch.zeros((1, 1), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 2)
