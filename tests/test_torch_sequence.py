"""The port's sequence-parallel slice against the JAX package: the plain
versions of the partial-state kernel ``flash_attention_partial`` and its
backward ``flash_attention_bwd`` against the Pallas kernels in interpret
mode and the lax formulation, ``_FlashPartialFn``'s gradient against the
JAX ``custom_vjp`` (and the lax vjp, which keeps m's cotangent), the
state helpers, and ``mt.sequence``'s ``ring_attention`` and
``ulysses_attention`` (values, gradients, the decode-time ``q_offset``
layout) against ``mxnet_tpu.sequence`` on the conftest's 8 virtual CPU
devices.

Inputs come from numpy seeds, scaled by 0.5 as ``tests/test_sequence.py``
makes them.  Tolerances (fp32), those of ``test_torch_dpa.py``: forwards
rtol=atol=1e-5; gradients rtol=atol=5e-5.  Both packages compute the
same functions and sum in other orders (the port's key blocks against
the Pallas tile of 128 keys, torch's matmuls against XLA's), which puts
forwards ~1e-7 and gradients a few 1e-7 apart.  m is compared on its
-inf pattern exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import sequence as jseq
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import sequence as tseq
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding the others that share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(B=2, T=32, H=4, D=8, seed=0, Tk=None):
    """q (B, T, H, D), k and v (B, Tk, H, D), N(0, 0.25), float32."""
    rng = np.random.RandomState(seed)
    Tk = T if Tk is None else Tk
    mk = lambda t: (rng.randn(B, t, H, D) * 0.5).astype(np.float32)  # noqa
    return mk(T), mk(Tk), mk(Tk)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _assert_state(got, want, **tol):
    """Partial states (o, m, l) equal: m's -inf pattern exactly, its
    finite values, o and l within ``tol``."""
    o, m, l = (np.asarray(x) for x in got)
    wo, wm, wl = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(np.isneginf(m), np.isneginf(wm))
    assert np.isfinite(m[~np.isneginf(m)]).all()
    np.testing.assert_allclose(m[~np.isneginf(m)], wm[~np.isneginf(wm)],
                               **tol)
    np.testing.assert_allclose(o, wo, **tol)
    np.testing.assert_allclose(l, wl, **tol)


# ---------------------------------------------------------------------------
# B8 / B9: the plain versions against the Pallas kernels and the lax body
# ---------------------------------------------------------------------------

OFFSETS = [0, -64, 32, 200]  # diagonal, past, some rows see nothing, none
# sees anything (T = 160: no multiple of the Pallas tile of 128)


@pytest.mark.parametrize("kv_offset", OFFSETS)
@pytest.mark.parametrize("causal", [False, True])
def test_partial_plain_vs_pallas_and_lax(monkeypatch, causal, kv_offset):
    q, k, v = _qkv(B=1, T=160, H=2, D=16, seed=abs(kv_offset))
    got = ck.flash_attention_partial_plain(*_t(q, k, v), causal=causal,
                                           block_size=32,
                                           kv_offset=kv_offset)
    o, m, l = got
    assert o.shape == (1, 2, 160, 16) and m.shape == l.shape == (1, 2, 160)
    assert all(x.dtype == torch.float32 for x in got)
    if causal and kv_offset > 0:  # rows before kv_offset see no key
        rows = min(kv_offset, 160)
        assert bool(torch.isneginf(m[..., :rows]).all())
        assert not bool(o[..., :rows, :].any() or l[..., :rows].any())
        assert bool(torch.isfinite(m[..., rows:]).all())

    monkeypatch.setenv("MXNET_PALLAS", "1")  # interpret mode on the CPU
    assert pk.enabled()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _assert_state(got, pk.flash_attention_partial(jq, jk, jv, causal, 128,
                                                  kv_offset), **FWD)
    _assert_state(got, jatt._blockwise_attention_partial_lax(
        jq, jk, jv, causal, 32, kv_offset), **FWD)


@pytest.mark.parametrize("kv_offset", OFFSETS)
@pytest.mark.parametrize("causal", [False, True])
def test_partial_bwd_plain_vs_pallas(monkeypatch, causal, kv_offset):
    """B9's plain version against the Pallas backward on the same m and
    cotangents of o and l."""
    q, k, v = _qkv(B=1, T=160, H=2, D=16, seed=7 + abs(kv_offset))
    rng = np.random.RandomState(11)
    ob = rng.randn(1, 2, 160, 16).astype(np.float32)
    lb = rng.randn(1, 2, 160).astype(np.float32)
    tq, tk, tv, tob, tlb = _t(q, k, v, ob, lb)
    _, m, _ = ck.flash_attention_partial_plain(tq, tk, tv, causal, 32,
                                               kv_offset)
    got = ck.flash_attention_bwd_plain(tq, tk, tv, m, tob, tlb, causal, 32,
                                       kv_offset)
    assert [g.shape for g in got] == [tq.shape, tk.shape, tv.shape]

    monkeypatch.setenv("MXNET_PALLAS", "1")
    want = pk.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, m.numpy(), ob, lb)), causal,
        128, kv_offset)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
    if causal and kv_offset >= 160:
        assert not any(bool(g.any()) for g in got)


@pytest.mark.parametrize("causal,kv_offset", [(False, 0), (True, 0),
                                              (True, 32)])
def test_flash_partial_fn_gradient_vs_jax_custom_vjp(monkeypatch, causal,
                                                     kv_offset):
    """``_FlashPartialFn`` (through ``blockwise_attention_partial``, a
    ring-style ``attention_state_merge`` and ``normalize_attention_state``)
    against the JAX ``custom_vjp`` and against the lax vjp, which keeps
    m's cotangent: dropping it is exact.  The first state's block sits at
    ``kv_offset`` (with 32, its first 32 rows see no key), the second's
    wholly in the past, so every merged row sees keys (normalizing a row
    that saw none gives the JAX reference a NaN gradient through
    ``jnp.maximum(l, 1e-30)``)."""
    q, k, v = _qkv(B=1, T=96, H=2, D=16, seed=5, Tk=192)
    w = np.random.RandomState(6).randn(1, 96, 2, 16).astype(np.float32)

    def run(api, q, k, v, **kw):
        a = api.blockwise_attention_partial(q, k[:, :96], v[:, :96],
                                            causal=causal,
                                            kv_offset=kv_offset, **kw)
        b = api.blockwise_attention_partial(q, k[:, 96:], v[:, 96:],
                                            causal=causal, kv_offset=-96,
                                            **kw)
        return api.normalize_attention_state(
            *api.attention_state_merge(*a, *b), q.dtype)

    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    _, m, _ = tatt.blockwise_attention_partial(*leaves, causal=causal,
                                               kv_offset=kv_offset)
    assert not m.requires_grad  # m's cotangent is never formed
    (run(tatt, *leaves, block_size=32) * torch.from_numpy(w)).sum().backward()

    def loss(q, k, v):
        return (run(jatt, q, k, v, block_size=128) * w).sum()

    for flag in ("1", "0"):  # the custom_vjp (Pallas), then the lax vjp
        monkeypatch.setenv("MXNET_PALLAS", flag)
        # a fresh jit per flag: MXNET_PALLAS is read while tracing
        want = jax.jit(jax.grad(lambda *x: loss(*x), argnums=(0, 1, 2)))(
            *(jnp.asarray(x) for x in (q, k, v)))
        for a, b in zip(leaves, want):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       err_msg=f"MXNET_PALLAS={flag}", **GRAD)


def test_partial_forward_equals_the_plain_body_and_launches_nothing_on_cpu():
    q, k, v = _t(*_qkv(T=24, seed=2))
    ck.reset_launch_counts()
    got = tatt.blockwise_attention_partial(q, k, v, causal=True,
                                           block_size=8, kv_offset=-5)
    want = tatt._blockwise_attention_partial_plain(q, k, v, True, 8, -5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(ck.LAUNCHES.values())


def test_attention_state_init_and_merge_vs_jax():
    """The empty state and the merge against the JAX helpers, with rows
    empty on either side (m = -inf): exact, no NaN."""
    rng = np.random.RandomState(3)
    q = (rng.randn(2, 6, 3, 4) * 0.5).astype(np.float32)
    o0, m0, l0 = tatt.attention_state_init(torch.from_numpy(q))
    jo0, jm0, jl0 = jatt.attention_state_init(jnp.asarray(q))
    _assert_state((o0, m0, l0), (jo0, jm0, jl0), rtol=0, atol=0)
    assert o0.shape == (2, 3, 6, 4) and o0.dtype == torch.float32

    def state(seed):
        r = np.random.RandomState(seed)
        o = r.randn(2, 3, 6, 4).astype(np.float32)
        m = r.randn(2, 3, 6).astype(np.float32)
        l = (r.rand(2, 3, 6) + 0.5).astype(np.float32)
        empty = r.rand(2, 3, 6) < 0.3
        m[empty] = -np.inf
        o[empty] = 0.0
        l[empty] = 0.0
        return o, m, l

    a, b = state(4), state(5)
    got = tatt.attention_state_merge(*_t(*a), *_t(*b))
    want = jatt.attention_state_merge(*(jnp.asarray(x) for x in a + b))
    _assert_state(got, want, rtol=1e-6, atol=1e-6)
    assert not any(bool(torch.isnan(x).any()) for x in got)
    # merging into the empty state returns the other state exactly
    merged = tatt.attention_state_merge(o0, m0, l0, *_t(*b))
    for x, y in zip(merged, _t(*b)):
        assert torch.equal(x, y)


def test_plain_versions_of_other_kernels_do_not_touch_the_partial_counter(
        monkeypatch):
    """The plain versions of B1, B2, B3 and B5 run the plain partial body:
    none of them goes through the B8 wrapper, whatever the device, so
    their checks on the card cannot count B8 launches."""
    calls = []
    real = ck.flash_attention_partial
    monkeypatch.setattr(ck, "flash_attention_partial",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ck.reset_launch_counts()
    rng = np.random.RandomState(9)
    qkv = torch.from_numpy(rng.randn(1, 10, 3 * 2 * 8).astype(np.float32))
    ck.flash_mha_packed_plain(qkv, 2, causal=True)
    q, k, v = _t(*(rng.randn(1, 2, 10, 8).astype(np.float32)
                   for _ in range(3)))
    ck.flash_mha_plain(q, k, v, causal=True)
    pool = torch.from_numpy(rng.randn(3, 4, 2, 8).astype(np.float32))
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lengths = torch.tensor([6], dtype=torch.int32)
    qd = torch.from_numpy(rng.randn(1, 2, 8).astype(np.float32))
    ck.paged_attention_decode_plain(qd, pool, pool, table, lengths)
    scale = torch.ones((3, 4, 2))
    ck.paged_attention_decode_quant_plain(
        qd, pool.to(torch.int8), pool.to(torch.int8), scale, scale, table,
        lengths)
    assert calls == [] and not any(ck.LAUNCHES.values())


def test_partial_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v = _t(*_qkv(T=8))
    with pytest.raises(MXNetError, match="Python int"):
        ck.flash_attention_partial(q, k, v, True, 8, torch.tensor(3))
    with pytest.raises(MXNetError, match="must be an int"):
        tatt.blockwise_attention_partial(q, k, v, kv_offset=1.5)
    with pytest.raises(MXNetError, match="outside int32"):
        ck.flash_attention_partial(q, k, v, True, 8, 2 ** 31)
    with pytest.raises(MXNetError, match="shapes disagree"):
        ck.flash_attention_partial(q, k[..., :4], v, True, 8, 0)
    with pytest.raises(MXNetError, match="dtypes differ"):
        ck.flash_attention_partial(q, k.double(), v, True, 8, 0)
    with pytest.raises(MXNetError, match="requires a gradient"):
        ck.flash_attention_partial(q.requires_grad_(), k, v, True, 8, 0)
    _, m, _ = ck.flash_attention_partial_plain(q.detach(), k, v, True, 8, 0)
    with pytest.raises(MXNetError, match="shapes disagree"):
        ck.flash_attention_bwd(q.detach(), k, v, m[..., :4], None, None)
    # a None cotangent is zeros
    dq, dk, dv = ck.flash_attention_bwd(q.detach(), k, v, m, None, None,
                                        True, 8, 0)
    assert not (dq.any() or dk.any() or dv.any())


# ---------------------------------------------------------------------------
# mt.sequence against mxnet_tpu.sequence on the virtual CPU mesh
# ---------------------------------------------------------------------------


def _jax_mesh(sp):
    if len(jax.devices()) < sp:
        pytest.skip("needs the conftest's virtual device mesh")
    return jseq.sequence_mesh(sp=sp)


def _jax_seq(fn, sp, **kw):
    """``mxnet_tpu.sequence``'s ``fn`` ("ring" or "ulysses") on an sp-way
    mesh, jitted over (q, k, v) (eager shard_map retraces op by op, ~20x
    slower)."""
    run = jseq.ring_attention if fn == "ring" else jseq.ulysses_attention
    mesh = _jax_mesh(sp)
    return jax.jit(lambda q, k, v: run(q, k, v, mesh, **kw))


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_vs_jax(causal, sp):
    q, k, v = _qkv(T=40, seed=sp)
    want = np.asarray(_jax_seq("ring", sp, causal=causal,
                               block_size=8)(q, k, v))
    mesh = tseq.sequence_mesh(sp, ["cpu"] * sp)
    ck.reset_launch_counts()
    got = tseq.ring_attention(*_t(q, k, v), mesh, causal=causal,
                              block_size=8)
    assert got.shape == q.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert not any(ck.LAUNCHES.values())  # the CPU runs the plain versions


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_vs_jax(causal):
    q, k, v = _qkv(T=32, H=4, seed=8)
    want = np.asarray(_jax_seq("ulysses", 4, causal=causal,
                               block_size=8)(q, k, v))
    got = tseq.ulysses_attention(*_t(q, k, v),
                                 tseq.sequence_mesh(4, CPU4),
                                 causal=causal, block_size=8)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("fn", ["ring", "ulysses"])
def test_sequence_gradients_vs_jax(fn):
    """The shapes of ``test_sequence.py``'s ``test_ring_attention_
    gradients``: d(sum(out**2)) through the port's autograd (B9 once a
    hop for the ring) against ``jax.grad`` through shard_map."""
    q, k, v = _qkv(T=16, H=2, D=4, seed=3) if fn == "ring" else \
        _qkv(T=16, H=4, D=4, seed=3)
    trun = tseq.ring_attention if fn == "ring" else tseq.ulysses_attention
    jrun = _jax_seq(fn, 4, causal=True, block_size=4)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jrun(q, k, v) ** 2),
                            argnums=(0, 1, 2)))(q, k, v)
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    (trun(*leaves, tseq.sequence_mesh(4, CPU4), causal=True,
          block_size=4) ** 2).sum().backward()
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("fn", ["ring", "ulysses"])
@pytest.mark.parametrize("q_offset", [0, 8, 24])
def test_decode_layout_vs_jax(fn, q_offset):
    """A chunk of q at ``q_offset`` into the full K/V (Tq != Tkv): the
    port against the JAX package, and both against the same rows of a
    full causal forward."""
    T_kv, T_q = 32, 8
    q_full, k, v = _qkv(T=T_kv, H=4)
    q = q_full[:, q_offset:q_offset + T_q]
    trun = tseq.ring_attention if fn == "ring" else tseq.ulysses_attention
    want = np.asarray(_jax_seq(fn, 4, causal=True, block_size=8,
                               q_offset=q_offset)(q, k, v))
    got = trun(*_t(q, k, v), tseq.sequence_mesh(4, CPU4), causal=True,
               block_size=8, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    full = tatt.blockwise_attention(*_t(q_full, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(),
                               full[:, q_offset:q_offset + T_q].numpy(),
                               **FWD)


def test_decode_layout_gradients_vs_jax():
    """The decode layout differentiated: the ring's hops include blocks
    whose first rows see no key (positive kv_offset) and a local block
    wholly in the future, skipped."""
    q_full, k, v = _qkv(T=32, H=2, D=4, seed=12)
    q = q_full[:, 12:20]
    jrun = _jax_seq("ring", 4, causal=True, block_size=4, q_offset=12)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jrun(q, k, v) ** 2),
                            argnums=(0, 1, 2)))(q, k, v)
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    (tseq.ring_attention(*leaves, tseq.sequence_mesh(4, CPU4), causal=True,
                         block_size=4, q_offset=12) ** 2).sum().backward()
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)


def test_decode_layout_uneven_chunk_cover():
    """Chunks tiled over the prompt reproduce the full forward row range
    by row range, through the port's ring as through the JAX one."""
    T_kv, chunk = 32, 16
    q_full, k, v = _qkv(T=T_kv, H=4, seed=5)
    mesh = tseq.sequence_mesh(4, CPU4)
    full = tatt.blockwise_attention(*_t(q_full, k, v), causal=True).numpy()
    for off in range(0, T_kv, chunk):
        q = q_full[:, off:off + chunk]
        got = tseq.ring_attention(*_t(q, k, v), mesh, causal=True,
                                  block_size=8, q_offset=off).numpy()
        want = np.asarray(_jax_seq("ring", 4, causal=True, block_size=8,
                                   q_offset=off)(q, k, v))
        np.testing.assert_allclose(got, full[:, off:off + chunk], **FWD)
        np.testing.assert_allclose(got, want, **FWD)


def test_sequence_mesh_and_errors_match_jax():
    mesh = tseq.sequence_mesh(2, ["cpu", mt.cpu(), torch.device("cpu")])
    assert mesh.size == 2 and mesh.axis_name == "sp"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with mt.cpu():
        assert tseq.sequence_mesh().devices == [torch.device("cpu")]
    with pytest.raises(MXNetError, match="exceeds"):
        tseq.sequence_mesh(5, CPU4)
    from mxnet_tpu.base import MXNetError as JaxMXNetError
    with pytest.raises(JaxMXNetError, match="exceeds"):
        jseq.sequence_mesh(sp=len(jax.devices()) + 1)
    q, k, v = _qkv(T=32, H=6)  # 6 heads over 4 shards
    with pytest.raises(MXNetError, match="divisible by sp"):
        tseq.ulysses_attention(*_t(q, k, v), tseq.sequence_mesh(4, CPU4))
    with pytest.raises(JaxMXNetError, match="divisible by sp"):
        jseq.ulysses_attention(q, k, v, _jax_mesh(4))
    with pytest.raises(MXNetError, match="not divisible"):
        tseq.ring_attention(*_t(*_qkv(T=30)), tseq.sequence_mesh(4, CPU4))
    with pytest.raises(MXNetError, match="axis"):
        tseq.ring_attention(*_t(*_qkv(T=32)), tseq.sequence_mesh(4, CPU4),
                            axis_name="tp")


def test_sequence_holds_no_try_statement():
    """As the kernel wrappers (``test_torch_build.py``): a kernel that
    fails on a CUDA tensor inside the ring raises, never falls back."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tseq))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_sequence_is_exported():
    assert mt.sequence is tseq
    assert set(tseq.__all__) >= {"sequence_mesh", "ring_attention",
                                 "ulysses_attention"}


@pytest.mark.cuda
def test_partial_kernels_on_the_card():
    """On CUDA tensors B8 and B9 launch and equal their plain versions
    (a Tq tail, rows that see no key, and head width 80), and a ring over
    four shards of one card launches B8 once a visible hop and B9 once a
    hop in the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); python3 chip_smoke.py runs them there")
    q, k, v = (torch.from_numpy(x).cuda()
               for x in _qkv(B=1, T=100, H=3, D=80, seed=1))
    for koff in (0, -40, 30):
        ck.reset_launch_counts()
        got = ck.flash_attention_partial(q, k, v, True, 32, koff)
        want = ck.flash_attention_partial_plain(q, k, v, True, 32, koff)
        _assert_state([x.cpu() for x in got], [x.cpu() for x in want],
                      **FWD)
        ob = torch.randn_like(got[0])
        lb = torch.randn_like(got[2])
        grads = ck.flash_attention_bwd(q, k, v, got[1], ob, lb, True, 32,
                                       koff)
        refs = ck.flash_attention_bwd_plain(q, k, v, got[1], ob, lb, True,
                                            32, koff)
        for a, b in zip(grads, refs):
            torch.testing.assert_close(a, b, **GRAD)
        assert ck.LAUNCHES["flash_attention_partial"] == 1
        assert ck.LAUNCHES["flash_attention_bwd_dq"] == 1
        assert ck.LAUNCHES["flash_attention_bwd_dkv"] == 1
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ck.reset_launch_counts()
    out = tseq.ring_attention(*leaves, tseq.sequence_mesh(4, ["cuda:0"] * 4),
                              causal=True)
    out.sum().backward()
    assert ck.LAUNCHES["flash_attention_partial"] == 10
    assert ck.LAUNCHES["flash_attention_bwd_dq"] == 10
    ref = tatt.blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(out.detach(), ref, **FWD)
