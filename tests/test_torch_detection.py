"""The port's SSD detection ops against the JAX package: ``nms_plain``
against the Pallas ``nms`` kernel in interpret mode and against the JAX
op's lax loop, ``MultiBoxPrior``, ``MultiBoxTarget`` (with and without
hard-negative mining), ``MultiBoxDetection`` and ``smooth_l1``, in
float32 and (detection and targets) in bfloat16 and float16; the B7
kernels' designs (``csrc/nms.cu``: suppression mask and blocked sweep;
under force the survivors' kernel) emulated in torch against
``nms_plain``; the ``nms`` wrapper's routing and, on a card, the
kernels against their plain version.

Inputs come from numpy seeds.  Tolerances (fp32): what is a decision is
exact (NMS classes, ``cls_target``, ``loc_mask``); the rows' other
columns are bit-equal after NMS; the anchors are exact at the SSD's
shape and within 6e-8 elsewhere (XLA fuses some of the JAX op's
multiply-adds); ``loc_target`` rtol 1e-5,
atol 1e-6 (a log and two divisions, a few ulps apart); detection rows
rtol=atol=1e-5 (an exp in the decode).  In bfloat16 and float16 the
tolerances are the dtype's machine epsilon (its ulp at 1), below.
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


@pytest.mark.parametrize("nms", [0.45, 0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_detection_and_targets_match_jax(dtype, nms):
    """C12: with bfloat16 or float16 inputs both packages decode, score
    and sort in that dtype and return float32 rows (float32 class ids);
    the NMS runs on those float32 rows, with NMS on and off.
    ``MultiBoxTarget`` (hard mining with NMS on, without it off) returns
    ``cls_target`` and ``loc_target`` in the labels' dtype and
    ``loc_mask`` in float32.  Classes, ``cls_target`` and ``loc_mask``
    are exact.  The rows' other columns lie in [0, 1] (clipped) or are
    -1 and may differ by the dtype's epsilon (its ulp at 1; two ulps in
    [0.5, 1)): XLA keeps float32 between some of the decode's ops (a
    multiply-add, an exp, a halving, a sum) where torch rounds each one
    to the dtype; measured: one ulp.  ``loc_target`` (a log and two
    divisions, values to ~3.5) within the epsilon relative and absolute.
    Each package's NMS output is ``nms_plain`` of its own rows before
    NMS, bit for bit."""
    eps = float(torch.finfo(getattr(torch, dtype)).eps)

    def run(name, inputs, attrs):
        j, _ = jax_invoke(name, [jnp.asarray(x).astype(dtype)
                                 for x in inputs], attrs)
        t, _ = torch_invoke(name, [torch.from_numpy(np.array(x)).to(
            getattr(torch, dtype)) for x in inputs], attrs)
        dtypes = [str(x.dtype) for x in j]
        assert dtypes == [str(x.dtype).replace("torch.", "") for x in t]
        return ([np.asarray(x).astype(np.float32) for x in j],
                [x.float().numpy() for x in t], dtypes)

    cls_prob, loc_pred, anchors = _detection_inputs(3, 48, 4, seed=2)
    attrs = {"threshold": 0.3, "nms_threshold": nms}
    (want,), (got,), dtypes = run("MultiBoxDetection",
                                  [cls_prob, loc_pred, anchors], attrs)
    assert dtypes == ["float32"]
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=0,
                               atol=eps)
    if nms:
        (jraw,), (traw,), _ = run("MultiBoxDetection",
                                  [cls_prob, loc_pred, anchors],
                                  dict(attrs, nms_threshold=0))
        assert (want[:, :, 0] < 0).sum() > (jraw[:, :, 0] < 0).sum()
        for raw, out in ((jraw, want), (traw, got)):
            plain = ck.nms_plain(torch.from_numpy(raw), nms, False).numpy()
            np.testing.assert_array_equal(plain, out)

    anchors_t, labels, cls_preds = _target_inputs(3)
    want_t, got_t, dtypes = run(
        "MultiBoxTarget", [anchors_t, labels, cls_preds],
        {"overlap_threshold": 0.5,
         "negative_mining_ratio": 3.0 if nms else -1.0})
    assert dtypes == [dtype, "float32", dtype]
    np.testing.assert_array_equal(got_t[2], want_t[2])
    np.testing.assert_array_equal(got_t[1], want_t[1])
    np.testing.assert_allclose(got_t[0], want_t[0], rtol=eps, atol=eps)
    assert (got_t[2][0] > 0).any() and (got_t[2][0] == 0).any()


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


def nms_edge_rows(B, A, seed, classes=3):
    """``nms_rows`` with the kernel's edge cases: every 7th row dead
    before NMS (interleaved, not only at the tail), every 9th row's box a
    duplicate of the row before it (IoU exactly 1), and, from A = 4 on,
    rows 2 and 3 of class 0 with boxes [0, 0, 1, 1] and [0, 0, 1, h],
    h = float32(0.45): their float32 IoU is exactly 0.45 (inter h, union
    1 + h - h = 1)."""
    rows = nms_rows(B, A, seed, classes=classes)
    rows[:, 3::7, 0] = -1.0
    dup = np.arange(9, A, 9)
    rows[:, dup, 2:] = rows[:, dup - 1, 2:]
    if A >= 4:
        rows[:, 2:4, 0] = 0.0
        rows[:, 2, 2:] = [0.0, 0.0, 1.0, 1.0]
        rows[:, 3, 2:] = [0.0, 0.0, 1.0, np.float32(0.45)]
    return rows


def _iou_at_least(rows, thr):
    """[i, j]: IoU(j, i) >= thr over one image's rows, in the kernel's
    order of operations (float32, no fused multiply-add)."""
    l, t, r, b = (rows[:, k] for k in (2, 3, 4, 5))
    w = torch.minimum(r[None, :], r[:, None]) \
        - torch.maximum(l[None, :], l[:, None])
    h = torch.minimum(b[None, :], b[:, None]) \
        - torch.maximum(t[None, :], t[:, None])
    inter = torch.clamp(w, min=0.0) * torch.clamp(h, min=0.0)
    area = (r - l) * (b - t)
    union = (area[None, :] + area[:, None]) - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)
    return iou >= thr


def emulate_mask_and_sweep(rows, thr):
    """csrc/nms.cu's design with force_suppress off, from its own rules.
    The mask: word J (int64) of row i holds bit jj for column j = 64 J +
    jj when j > i, both rows are live (cls >= 0), the classes match and
    IoU(j, i) >= thr, in the kernel's order of operations.  The sweep,
    block by block: the lowest live row of the block not yet removed
    survives and its diagonal word removes the later rows it
    suppresses, then the next; the survivors' later words are ORed into
    the removed words.  Rows whose bit is set get cls -1."""
    B, A, _ = rows.shape
    nb = -(-A // 64)
    weights = torch.tensor([1 << k for k in range(63)] + [-(1 << 63)])
    out = rows.clone()
    for img in range(B):
        cls = rows[img, :, 0]
        live = cls >= 0
        idx = torch.arange(A)
        cand = (idx[None, :] > idx[:, None]) & live[:, None] & live[None, :]
        cand &= cls[None, :] == cls[:, None]
        bits = torch.zeros((A, nb * 64), dtype=torch.int64)
        bits[:, :A] = (cand & _iou_at_least(rows[img], thr)).to(torch.int64)
        words = (bits.view(A, nb, 64) * weights).sum(-1)  # distinct bits
        mask = [[w & (2 ** 64 - 1) for w in row] for row in words.tolist()]
        removed = [0] * nb
        for I in range(nb):
            block = range(I * 64, min(A, I * 64 + 64))
            todo = sum(1 << (j - I * 64) for j in block if live[j])
            R = removed[I]
            todo &= ~R
            survivors = []
            while todo:
                k = (todo & -todo).bit_length() - 1
                d = mask[I * 64 + k][I]
                R |= d
                todo &= ~d & (todo - 1)
                survivors.append(I * 64 + k)
            removed[I] = R
            for w in range(I + 1, nb):
                for i in survivors:
                    removed[w] |= mask[i][w]
        gone = [j for j in range(A) if removed[j >> 6] >> (j & 63) & 1]
        assert all(live[j] for j in gone)  # only live rows are marked
        out[img, gone, 0] = -1.0
    return out


def emulate_force_kernel(rows, thr):
    """csrc/nms.cu's ``nms_force_kernel`` (force_suppress on), from its
    own rules: live and removed bits in 32-bit words; blocks of 64 rows
    in order, up to the last that holds a live row.  A block's standing
    rows (live, not removed) are resolved in order: the lowest survives
    and removes the later standing rows of the block it suppresses,
    then the next.  Every live row of the block but its survivors is
    then removed.  A block with survivors is followed by a scan of the
    later rows a 32-bit word at a time: a word with no standing row is
    skipped, and a standing row tests the survivors in order until one
    suppresses it (IoU(j, i) >= thr, the kernel's arithmetic)."""
    B, A, _ = rows.shape
    nb = -(-A // 64)
    out = rows.clone()
    for img in range(B):
        sup = _iou_at_least(rows[img], thr)  # [i, j]
        live_rows = (rows[img, :, 0] >= 0).tolist() + [False] * (64 * nb - A)
        live = [sum(1 << k for k in range(32) if live_rows[32 * w + k])
                for w in range(2 * nb)]
        removed = [0] * (2 * nb)
        last = max((w // 2 + 1 for w in range(2 * nb) if live[w]), default=0)
        for I in range(last):
            standing = [j for j in range(64 * I, 64 * I + 64)
                        if live[j >> 5] >> (j & 31) & 1
                        and not removed[j >> 5] >> (j & 31) & 1]
            survivors = []
            while standing:
                s = standing.pop(0)
                survivors.append(s)
                standing = [j for j in standing if not sup[s, j]]
            for w in (2 * I, 2 * I + 1):
                removed[w] = live[w] & ~sum(1 << (s & 31) for s in survivors
                                            if s >> 5 == w)
            if not survivors:
                continue
            for w in range(2 * I + 2, 2 * nb):
                todo = live[w] & ~removed[w]
                while todo:
                    k = (todo & -todo).bit_length() - 1
                    if any(sup[s, 32 * w + k] for s in survivors):
                        removed[w] |= 1 << k
                    todo &= todo - 1
        gone = [j for j in range(A) if removed[j >> 5] >> (j & 31) & 1]
        assert all(live_rows[j] for j in gone)  # only live rows are marked
        out[img, gone, 0] = -1.0
    return out


@pytest.mark.parametrize("thr", [0.45, 0.0, 1.0])
@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("A", [1, 63, 64, 65, 200, 257, 321])
def test_nms_kernel_design_emulated_matches_nms_plain(A, force, thr):
    """The B7 kernels' designs, emulated in torch (force off: the mask
    and the blocked sweep; force on: the survivors' kernel), equal
    ``nms_plain`` bit for bit: ragged last words, one row, interleaved
    dead rows, duplicate boxes, a pair whose IoU equals 0.45, and the
    thresholds 0 (every live pair of a class, or under force every live
    pair, suppresses) and 1 (only duplicates do)."""
    rows = torch.from_numpy(nms_edge_rows(3, A, seed=A))
    thr32 = float(torch.tensor(thr, dtype=torch.float32))
    got = emulate_force_kernel(rows, thr32) if force \
        else emulate_mask_and_sweep(rows, thr32)
    want = ck.nms_plain(rows, thr, force)
    assert torch.equal(got, want)
    if A >= 4:
        kept = int((want[:, :, 0] >= 0).sum())
        assert kept < int((rows[:, :, 0] >= 0).sum())  # some suppression
        assert bool((want[:, 3, 0] < 0).all()) == (thr <= 0.45)


def test_nms_wrapper_groups_images_by_its_workspace(monkeypatch):
    """The wrapper's host path, with the CUDA entry point replaced by a
    recorder: under ``force_suppress``, and for A <=
    ``NMS_FUSED_MAX_ROWS``, one launch with no workspace; a larger A
    with force off gets a workspace of whole images, as many as
    ``NMS_WORKSPACE_BUDGET`` holds, and the images run in groups over
    it; one call counts one launch; an image whose mask exceeds the
    budget is refused, force on or off.  ``_nms_launch`` over a given
    workspace runs the mask and the sweep at any A and counts none."""
    import contextlib
    import types

    calls = []

    def entry(rows, out, ws, B, A, thr, force, stream):
        calls.append((rows, out, ws, B, A, force))
        return 0

    monkeypatch.setattr(ck, "_route", lambda name, *ts: True)
    monkeypatch.setattr(ck, "_load", lambda *args: entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launch_counts()
    ck.nms(torch.zeros(8, 192, 6), 0.45, False)
    assert [c[2:] for c in calls] == [(0, 8, 192, 0)]
    rows = torch.zeros(5, 300, 6)
    calls.clear()
    ck.nms(rows, 0.45, True)
    assert [c[2:] for c in calls] == [(0, 5, 300, 1)]
    per_image = ck.nms_workspace_bytes(300)
    assert per_image == 300 * 5 * 8
    calls.clear()
    ck.nms(rows, 0.45, False)
    assert [c[3] for c in calls] == [5] and calls[0][2] != 0
    monkeypatch.setattr(ck, "NMS_WORKSPACE_BUDGET", 2 * per_image + 7)
    calls.clear()
    out = ck.nms(rows, 0.45, False)
    step, ws = 300 * 6 * 4, calls[0][2]
    assert [(c[0] - rows.data_ptr(), c[1] - out.data_ptr(), c[2], c[3])
            for c in calls] == [(0, 0, ws, 2), (2 * step, 2 * step, ws, 2),
                                (4 * step, 4 * step, ws, 1)]
    assert ck.LAUNCHES["nms"] == 4
    for force in (False, True):
        with pytest.raises(mt.MXNetError, match="exceeds"):
            ck.nms(torch.zeros(1, 1000, 6), 0.45, force)
    small = torch.empty(8 * ck.nms_workspace_bytes(192), dtype=torch.uint8)
    calls.clear()
    ck._nms_launch(torch.zeros(8, 192, 6), 0.45, False, small)
    assert [c[2:] for c in calls] == [(small.data_ptr(), 8, 192, 0)]
    assert ck.LAUNCHES["nms"] == 4


@pytest.mark.cuda
def test_nms_kernel_on_the_card():
    """On CUDA rows the kernels equal their plain version bit for bit, at
    the toy detector's shape (force off: the fused launch), SSD300's box
    count and 12,000 rows (force off: the mask in a workspace, then the
    sweep), force off and on (the survivors' kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); python3 chip_smoke.py runs them there")
    for B, A in ((8, 192), (2, 8732), (1, 12000)):
        rows = torch.from_numpy(nms_rows(B, A, seed=5, classes=20)).cuda()
        for force in (False, True):
            want = ck.nms_plain(rows, 0.45, force)
            ck.reset_launch_counts()
            got = ck.nms(rows, 0.45, force)
            assert ck.LAUNCHES["nms"] == 1
            assert torch.equal(got, want), (B, A, force)
