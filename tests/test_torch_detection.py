"""The port's SSD detection ops against the JAX package: ``nms_plain``
against the Pallas ``nms`` kernel in interpret mode and against the JAX
op's lax loop, ``MultiBoxPrior``, ``MultiBoxTarget`` (with and without
hard-negative mining), ``MultiBoxDetection`` and ``smooth_l1``; the
``nms`` wrapper's routing and, on a card, the kernel against its plain
version.

Inputs come from numpy seeds.  Tolerances (fp32): what is a decision is
exact (NMS classes, ``cls_target``, ``loc_mask``); the rows' other
columns are bit-equal after NMS; the anchors are exact at the SSD's
shape and within 6e-8 elsewhere (XLA fuses some of the JAX op's
multiply-adds); ``loc_target`` rtol 1e-5,
atol 1e-6 (a log and two divisions, a few ulps apart); detection rows
rtol=atol=1e-5 (an exp in the decode).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import detection as tdet
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding the timing-sensitive ones that share the
    host.  The worker's setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(name, inputs, attrs):
    outs, _ = jax_invoke(name, [jnp.asarray(x) for x in inputs], attrs)
    return [np.asarray(o) for o in outs]


def _torch(name, inputs, attrs):
    outs, _ = torch_invoke(name, [torch.from_numpy(np.array(x))
                                  for x in inputs], attrs)
    return [o.numpy() for o in outs]


def nms_rows(B, A, seed, classes=3, spread=0.6):
    """Score-sorted rows [cls, score, l, t, r, b] with clustered boxes
    (so that a good share is suppressed) and cls -1 below score 0.1."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((B, A, 6), np.float32)
    for b in range(B):
        score = np.sort(rng.rand(A))[::-1]
        cls = rng.randint(0, classes, size=A).astype(np.float32)
        cls[score < 0.1] = -1.0
        centers = rng.rand(A, 2) * spread + (1 - spread) / 2
        wh = rng.rand(A, 2) * 0.3 + 0.05
        rows[b, :, 0] = cls
        rows[b, :, 1] = score
        rows[b, :, 2:4] = centers - wh / 2
        rows[b, :, 4:6] = centers + wh / 2
    return rows


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_nms_plain_matches_the_pallas_kernel(monkeypatch, force, thr):
    rows = nms_rows(2, 48, seed=1)
    monkeypatch.setenv("MXNET_PALLAS", "1")  # interpret mode on the CPU
    want = np.asarray(pk.nms(jnp.asarray(rows), thr, force))
    got = ck.nms_plain(torch.from_numpy(rows), thr, force).numpy()
    assert (got[:, :, 0] < 0).sum() > (rows[:, :, 0] < 0).sum()  # some NMS
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])
    np.testing.assert_array_equal(got[:, :, 1:], rows[:, :, 1:])
    np.testing.assert_array_equal(want[:, :, 1:], rows[:, :, 1:])


def _detection_inputs(B, A, C, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, C, A).astype(np.float32) * 2
    cls_prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc_pred = (rng.randn(B, A * 4) * 0.5).astype(np.float32)
    anchors = _jax("MultiBoxPrior", [np.zeros((1, 3, 4, 4), np.float32)],
                   {"sizes": "(0.3, 0.6)", "ratios": "(1, 2)"})[0]
    assert anchors.shape == (1, A, 4)
    return cls_prob.astype(np.float32), loc_pred, anchors


def _no_pair_near(rows, thr, force, margin=1e-4):
    """True when no two rows alive before NMS (of one class unless
    ``force``) have an IoU within ``margin`` of ``thr``: the float64 IoU
    then decides every pair as both packages' float32 IoU does."""
    for r in rows:
        live = r[r[:, 0] >= 0].astype(np.float64)
        l, t, rr, b = (live[:, k] for k in range(2, 6))
        w = np.clip(np.minimum(rr[:, None], rr) - np.maximum(l[:, None], l),
                    0, None)
        h = np.clip(np.minimum(b[:, None], b) - np.maximum(t[:, None], t),
                    0, None)
        inter = w * h
        area = (rr - l) * (b - t)
        iou = inter / (area[:, None] + area - inter)
        pair = np.triu(np.ones_like(iou, bool), 1)
        if not force:
            pair &= live[:, None, 0] == live[None, :, 0]
        if np.any(np.abs(iou[pair] - thr) < margin):
            return False
    return True


@pytest.mark.parametrize("force", [False, True])
def test_multibox_detection_matches_jax(force):
    """Decode, sort and NMS against the JAX op on the CPU (its lax
    loop); with NMS off the sorted rows match too, and ``nms_plain`` of
    them equals the JAX op's suppressed rows."""
    cls_prob, loc_pred, anchors = _detection_inputs(3, 48, 4, seed=2)
    attrs = {"threshold": 0.3, "nms_threshold": 0.45,
             "force_suppress": force}
    raw_attrs = dict(attrs, nms_threshold=0)  # NMS off
    jraw = _jax("MultiBoxDetection", [cls_prob, loc_pred, anchors],
                raw_attrs)[0]
    assert _no_pair_near(jraw, 0.45, force)
    traw = _torch("MultiBoxDetection", [cls_prob, loc_pred, anchors],
                  raw_attrs)[0]
    np.testing.assert_array_equal(traw[:, :, 0], jraw[:, :, 0])
    np.testing.assert_allclose(traw[:, :, 1:], jraw[:, :, 1:], rtol=1e-5,
                               atol=1e-5)

    want = _jax("MultiBoxDetection", [cls_prob, loc_pred, anchors], attrs)[0]
    got = _torch("MultiBoxDetection", [cls_prob, loc_pred, anchors], attrs)[0]
    assert (want[:, :, 0] < 0).sum() > (jraw[:, :, 0] < 0).sum()  # some NMS
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=1e-5,
                               atol=1e-5)
    # the plain NMS of JAX's own sorted rows equals the lax loop's result
    plain = ck.nms_plain(torch.from_numpy(np.array(jraw)), 0.45,
                         force).numpy()
    np.testing.assert_array_equal(plain, want)


@pytest.mark.parametrize("hw", [(5, 7), (8, 8), (19, 13)])
@pytest.mark.parametrize("attrs", [
    {"sizes": "(0.3, 0.6)", "ratios": "(1, 2)"},
    {"sizes": "(0.5, 0.25, 0.1)", "ratios": "(1, 2, 0.5)", "clip": True},
    {"sizes": "(1.5,)", "clip": True},
])
def test_multibox_prior_matches_jax(attrs, hw):
    """Exact on the SSD's 8x8 map; elsewhere within 6e-8: XLA fuses some
    of the JAX op's ``center * step +- extent`` into a multiply-add
    (which ones depends on its fusion), where torch rounds the product
    first, half an ulp of a center below 1 (3e-8), then the sum."""
    data = np.zeros((2, 3) + hw, np.float32)
    want = _jax("MultiBoxPrior", [data], attrs)[0]
    got = _torch("MultiBoxPrior", [data], attrs)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)
    if hw == (8, 8):
        np.testing.assert_array_equal(got, want)
    s = mt.sym.MultiBoxPrior(mt.sym.Variable("data"), **attrs)
    assert s.infer_shape(data=data.shape)[1] == [want.shape]


def _target_inputs(seed):
    """Anchors of a 4x4 map, 3 images: 2 ground truths, 1, and none
    (an all -1 list), cls_preds (B, 3, A)."""
    rng = np.random.RandomState(seed)
    anchors = _jax("MultiBoxPrior", [np.zeros((1, 3, 4, 4), np.float32)],
                   {"sizes": "(0.3, 0.6)", "ratios": "(1, 2)"})[0]
    A = anchors.shape[1]
    labels = np.full((3, 3, 5), -1.0, np.float32)
    labels[0, 0] = [1, 0.1, 0.1, 0.45, 0.5]
    labels[0, 1] = [0, 0.5, 0.4, 0.95, 0.9]
    labels[1, 0] = [1, 0.3, 0.2, 0.6, 0.7]
    cls_preds = rng.randn(3, 3, A).astype(np.float32)
    return anchors, labels, cls_preds


@pytest.mark.parametrize("ratio", [3.0, -1.0])
def test_multibox_target_matches_jax(ratio):
    anchors, labels, cls_preds = _target_inputs(3)
    attrs = {"overlap_threshold": 0.5, "negative_mining_ratio": ratio}
    want = _jax("MultiBoxTarget", [anchors, labels, cls_preds], attrs)
    got = _torch("MultiBoxTarget", [anchors, labels, cls_preds], attrs)
    loc_t, loc_m, cls_t = got
    np.testing.assert_array_equal(cls_t, want[2])
    np.testing.assert_array_equal(loc_m, want[1])
    np.testing.assert_allclose(loc_t, want[0], rtol=1e-5, atol=1e-6)
    assert (cls_t[0] == 2).any() and (cls_t[0] == 1).any()  # positives
    assert (cls_t[0] == 0).any()  # negatives
    # hard mining leaves the rest ignored; without it every other
    # anchor of an image with ground truth is a negative
    assert (cls_t[0] == -1).any() == (ratio > 0)
    assert (cls_t[2] == -1).all()  # no ground truth: all ignored
    s = mt.sym.MultiBoxTarget(*[mt.sym.Variable(n) for n in "alc"])
    assert s.infer_shape(a=anchors.shape, l=labels.shape,
                         c=cls_preds.shape)[1] == [x.shape for x in want]


def test_smooth_l1_and_gradient():
    x = np.linspace(-3, 3, 61, dtype=np.float32).reshape(1, 61)
    for sigma in (1.0, 2.0):
        want = _jax("smooth_l1", [x], {"scalar": sigma})[0]
        t = torch.from_numpy(x).requires_grad_()
        got = tdet.smooth_l1(t, sigma)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-7)
        got.sum().backward()
        s2 = sigma * sigma
        np.testing.assert_allclose(
            t.grad.numpy(),
            np.where(np.abs(x) < 1 / s2, s2 * x, np.sign(x)), rtol=1e-6)


def test_nms_wrapper_routes_cpu_tensors_to_the_plain_version():
    rows = torch.from_numpy(nms_rows(2, 20, seed=4))
    ck.reset_launch_counts()
    got = ck.nms(rows, 0.4, False)
    assert torch.equal(got, ck.nms_plain(rows, 0.4, False))
    assert ck.LAUNCHES["nms"] == 0
    assert not torch.equal(got, rows)  # a new tensor; the input unchanged
    assert torch.equal(rows, torch.from_numpy(nms_rows(2, 20, seed=4)))
    with pytest.raises(mt.MXNetError, match="rows"):
        ck.nms(rows[..., :5], 0.4, False)


@pytest.mark.cuda
def test_nms_kernel_on_the_card():
    """On CUDA rows the kernel equals its plain version bit for bit, at
    the toy detector's shape, SSD300's box count (boxes in shared memory)
    and an A whose boxes stay in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); python3 chip_smoke.py runs them there")
    for B, A in ((8, 192), (2, 8732), (1, 12000)):
        rows = torch.from_numpy(nms_rows(B, A, seed=5, classes=20)).cuda()
        want = ck.nms_plain(rows, 0.45, False)
        ck.reset_launch_counts()
        got = ck.nms(rows, 0.45, False)
        assert ck.LAUNCHES["nms"] == 1
        assert torch.equal(got, want), (B, A)
