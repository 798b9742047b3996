"""The port's kernel build (``mxnet_tpu_torch/_build.py``) on the CPU,
with a stand-in for ``nvcc``: parallel builds, content-hashed library
names, reuse of a built library, and a failed compile that raises with
the compiler's output and leaves nothing half-written.  The real
compile runs on the card (``chip_smoke.py``)."""

import re
import shutil
import sys

import pytest

from mxnet_tpu_torch import MXNetError, _build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({record!r}, "a") as fh:
    fh.write(" ".join(args) + "\\n")
src = args[-1]
if "FAIL" in open(src).read():
    print("error: stand-in compile failure")
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as fh:
    fh.write("built from " + src)
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    record = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable,
                                     record=str(record)))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return record, csrc


def _with_headers(csrc, name):
    """The text of ``csrc/<name>.cu`` and of every ``csrc/`` header it
    includes, directly or through another header."""
    text = (csrc / f"{name}.cu").read_text()
    seen = []
    todo = re.findall(r'#include "([^"]+)"', text)
    while todo:
        hdr = todo.pop()
        if hdr not in seen:
            seen.append(hdr)
            body = (csrc / hdr).read_text()
            text += body
            todo += re.findall(r'#include "([^"]+)"', body)
    return text, seen


def test_build_all_kernels_once_with_sm90a_flags(fake):
    record, _ = fake
    assert "flash_mha_packed_bwd" in _build.SOURCES  # the backward kernels
    for name in ("paged_attention_decode_quant", "paged_attention_verify"):
        assert name in _build.SOURCES  # quantized decode and verify
    assert "lstm_scan" in _build.SOURCES  # the LSTM recurrence
    for name in ("flash_mha", "flash_mha_bwd"):
        assert name in _build.SOURCES  # DotProductAttention's kernels
    for name in ("flash_attention_partial", "flash_attention_partial_bwd"):
        assert name in _build.SOURCES  # the ring's partial-state kernels
    first = _build.build()
    assert set(first) == set(_build.SOURCES)
    assert all(t > 0 for t in first.values())
    calls = record.read_text().splitlines()
    assert len(calls) == len(_build.SOURCES)
    for c in calls:
        assert "arch=compute_90a,code=sm_90a" in c and "-shared" in c
    libs = sorted(p.name for p in _build.BUILD_DIR.iterdir())
    assert len(libs) == len(_build.SOURCES)
    assert all(n.startswith("lib") and n.endswith(".so") for n in libs)
    # built libraries are reused: no second compile
    assert _build.build() == {n: 0.0 for n in _build.SOURCES}
    assert len(record.read_text().splitlines()) == len(_build.SOURCES)


def test_edited_source_rebuilds_under_a_new_name(fake):
    _, csrc = fake
    name = "paged_attention_decode"
    before = _build._target(name)
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target(name) != before
    assert _build.build([name])[name] > 0


def test_edited_shared_header_rebuilds_every_paged_kernel(fake):
    """The paged kernels share csrc/paged_attention.cuh: editing it gives
    each of them a new library name, so no stale build is loaded."""
    _, csrc = fake
    paged = [n for n in _build.SOURCES if n.startswith("paged_attention")]
    assert len(paged) == 3
    for name in paged:
        assert '#include "paged_attention.cuh"' in \
            (csrc / f"{name}.cu").read_text()
    before = {n: _build._target(n) for n in _build.SOURCES}
    hdr = csrc / "paged_attention.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in paged)
    assert all(t > 0 for t in _build.build(paged).values())
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        after[n].name for n in paged)


def test_edited_tensor_core_header_rebuilds_exactly_its_kernels(fake):
    """B1's forward and backward, B5's forward and backward, B8 and B9
    share csrc/tensor_core.cuh: editing it gives exactly those six
    libraries new names; editing the paged header leaves them as they
    were.  A header is hashed only into the sources that include it."""
    _, csrc = fake
    users = ["flash_mha_packed", "flash_mha_packed_bwd", "flash_mha",
             "flash_mha_bwd", "flash_attention_partial",
             "flash_attention_partial_bwd"]
    for name in _build.SOURCES:
        headers = _with_headers(csrc, name)[1]
        assert ("tensor_core.cuh" in headers) == (name in users)
    before = {n: _build._target(n) for n in _build.SOURCES}
    hdr = csrc / "tensor_core.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == users
    assert all(t > 0 for t in _build.build(users).values())
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        after[n].name for n in users)
    paged = csrc / "paged_attention.cuh"
    paged.write_text(paged.read_text() + "\n// edited\n")
    again = {n: _build._target(n) for n in _build.SOURCES}
    assert all(again[n] == after[n] for n in users)


def test_edited_forward_header_rebuilds_exactly_the_three_forwards(fake):
    """B1's forward, B5's forward and B8 run one body,
    csrc/attention_fwd.cuh (which includes tensor_core.cuh): editing it
    gives exactly those three libraries new names."""
    _, csrc = fake
    users = ["flash_mha_packed", "flash_mha", "flash_attention_partial"]
    for name in _build.SOURCES:
        text = (csrc / f"{name}.cu").read_text()
        assert ('#include "attention_fwd.cuh"' in text) == (name in users)
        if name in users:  # one body: no kernel code of their own
            assert "exp2f" not in text and "cp_async" not in text
    before = {n: _build._target(n) for n in _build.SOURCES}
    hdr = csrc / "attention_fwd.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == users
    assert all(t > 0 for t in _build.build(users).values())


def test_failed_compile_raises_with_compiler_output(fake):
    _, csrc = fake
    (csrc / "flash_mha_packed.cu").write_text("FAIL\n")
    with pytest.raises(MXNetError, match="stand-in compile failure"):
        _build.build()
    # nothing half-written is left to be loaded later
    left = [p.name for p in _build.BUILD_DIR.iterdir()]
    assert not [n for n in left if n.endswith((".tmp", ".log"))]
    assert not [n for n in left if n.startswith("libflash_mha_packed-")]


def test_lstm_scan_source_exports_the_wrappers_entry_point(fake):
    """csrc/lstm_scan.cu stands alone (no shared header), takes float32
    and exports the C entry point ``ops.cuda_kernels.lstm_scan`` loads;
    editing it rebuilds it alone."""
    _, csrc = fake
    src = (csrc / "lstm_scan.cu").read_text()
    assert 'extern "C" int lstm_scan(' in src and ".cuh" not in src
    assert "kMaxHidden = 1024" in src
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    assert ck.LSTM_MAX_HIDDEN == 1024 and "lstm_scan" in ck.LAUNCHES
    before = {n: _build._target(n) for n in _build.SOURCES}
    (csrc / "lstm_scan.cu").write_text(src + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == \
        ["lstm_scan"]
    assert _build.build(["lstm_scan"])["lstm_scan"] > 0


def test_unknown_source_is_refused(fake):
    with pytest.raises(MXNetError, match="unknown kernel source"):
        _build.build(["no_such_kernel"])


def test_nms_source_kernel_and_wrapper(fake):
    """csrc/nms.cu stands alone, exports the entry point the wrapper
    loads (rows, out, the mask workspace or null, B, A, thr, force,
    stream), computes the IoU with round-to-nearest intrinsics (no
    contracted multiply-add), holds its four kernels (mask, sweep,
    fused, and the survivors' kernel under force), and mirrors the
    wrapper's one-launch limit; ``nms`` routes a CPU tensor to
    ``nms_plain`` without a launch, and counts one launch per CUDA call
    (its grouped host path:
    ``test_nms_wrapper_groups_images_by_its_workspace`` in
    test_torch_detection.py)."""
    import inspect

    _, csrc = fake
    src = (csrc / "nms.cu").read_text()
    assert 'extern "C" int nms(const void* rows, void* out, void* mask,' \
        in src and ".cuh" not in src
    for op in ("__fmul_rn", "__fsub_rn", "__fadd_rn", "__fdiv_rn",
               "nms_mask_kernel", "nms_sweep_kernel", "nms_fused_kernel",
               "nms_force_kernel",
               "return cudaGetLastError();", "constexpr int kBlock = 64;"):
        assert op in src
    assert "cudaMalloc" not in src and "Synchronize" not in src
    assert "template" not in src  # one instantiation a kernel
    assert "nms" in _build.SOURCES
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    assert f"kFusedMaxRows = {ck.NMS_FUSED_MAX_ROWS};" in src
    assert inspect.getsource(ck.nms).count('LAUNCHES["nms"] += 1') == 1
    assert "nms" in ck.LAUNCHES
    import torch

    rows = torch.rand(2, 9, 6)
    rows[:, :, 0] = torch.tensor([0., 1., 0., -1., 1., 0., 0., 1., 1.])
    ck.reset_launch_counts()
    assert torch.equal(ck.nms(rows, 0.2, False), ck.nms_plain(rows, 0.2,
                                                              False))
    assert ck.LAUNCHES["nms"] == 0
    before = {n: _build._target(n) for n in _build.SOURCES}
    (csrc / "nms.cu").write_text(src + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == ["nms"]


def test_multibox_detection_raises_for_rows_the_kernel_does_not_take():
    """``MultiBoxDetection`` gives float32 rows whatever its input dtype
    (C12: float32 class ids, as the JAX op), so its NMS always gets rows
    the kernel takes, with NMS on and off; the ``nms`` wrapper still
    refuses rows that are not (B, A, 6).  The name is historical: before
    C12 was repaired, bf16 rows with NMS on raised here."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops.detection import multibox_detection

    B, C, A = 2, 3, 12
    prob = torch.softmax(torch.randn(B, C, A), 1).to(torch.bfloat16)
    loc = torch.zeros(B, A * 4, dtype=torch.bfloat16)
    anchors = torch.rand(1, A, 4).to(torch.bfloat16)
    rows = multibox_detection(prob, loc, anchors)
    raw = multibox_detection(prob, loc, anchors, nms_threshold=0)
    assert rows.dtype == raw.dtype == torch.float32
    assert rows.shape == raw.shape == (B, A, 6)
    assert torch.equal(rows, ck.nms_plain(raw, 0.5, False))
    with pytest.raises(MXNetError, match="rows"):
        ck.nms(raw[..., :5], 0.5, False)


def test_no_code_path_catches_a_failed_launch():
    """The wrappers, the ops that call them, the imperative namespace
    that calls the ops and the user-kernel surface (``rtc``) hold no try
    statement, so a kernel that fails to build or launch on a CUDA
    tensor raises and never falls back to the plain version."""
    import ast
    import pathlib

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    for name in ("flash_mha", "flash_mha_bwd", "launch_flash_mha_bwd"):
        assert callable(getattr(ck, name))  # the B5 wrappers are scanned
    pkg = pathlib.Path(_build.__file__).parent
    for path in [pkg / "ops" / f"{name}.py" for name in
                 ("cuda_kernels", "attention", "rnn", "detection")] \
            + [pkg / "ndarray.py", pkg / "rtc.py"]:
        tree = ast.parse(path.read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.name} has try statements at {tries}"


@pytest.mark.parametrize("source,entries,loads,headers", [
    ("flash_mha", ("flash_mha_fwd", "flash_mha_smem_bytes"),
     ('_load("flash_mha", "flash_mha_fwd"',), ["attention_fwd.cuh"]),
    ("flash_mha_bwd", ("flash_mha_bwd_dq", "flash_mha_bwd_dkv",
                       "flash_mha_bwd_smem_bytes"),
     ('name = f"flash_mha_bwd_{part}"', '_load("flash_mha_bwd", name'),
     ["tensor_core.cuh"]),
])
def test_flash_mha_sources_export_the_wrappers_entry_points(
        fake, source, entries, loads, headers):
    """csrc/flash_mha.cu and flash_mha_bwd.cu (both on the tensor cores,
    through the shared tensor_core.cuh; the forward through the forward
    body attention_fwd.cuh) export the C entry points
    ``ops.cuda_kernels`` loads, and their dynamic shared-memory queries
    for chip_smoke.py's resource report; both return
    cudaGetLastError() and take head widths up to the wrappers' limit;
    each counts its launches, and editing one rebuilds it alone."""
    import inspect

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    _, csrc = fake
    assert source in _build.SOURCES
    src = (csrc / f"{source}.cu").read_text()
    assert re.findall(r'#include "([^"]+)"', src) == headers
    text = _with_headers(csrc, source)[0]
    assert "return cudaGetLastError();" in text
    assert f"kMaxHeadDim = {ck.FLASH_MHA_MAX_HEAD_DIM}" in text
    wrappers = inspect.getsource(ck)
    assert all(text in wrappers for text in loads)
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
    for name in ("flash_mha", "flash_mha_bwd_dq", "flash_mha_bwd_dkv"):
        assert name in ck.LAUNCHES
    before = {n: _build._target(n) for n in _build.SOURCES}
    (csrc / f"{source}.cu").write_text(src + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == [source]
    assert _build.build([source])[source] > 0


@pytest.mark.parametrize("source,entries,smem", [
    ("flash_mha_packed", ("flash_mha_packed_fwd",),
     "flash_mha_packed_smem_bytes(int D, int dtype)"),
    ("flash_mha_packed_bwd",
     ("flash_mha_packed_bwd_dq", "flash_mha_packed_bwd_dkv"),
     "flash_mha_packed_bwd_smem_bytes(int which, int D, int dtype)"),
])
def test_packed_sources_export_entry_points_and_shared_memory_queries(
        fake, source, entries, smem):
    """B1's forward and backward sources include only the tensor-core
    header, are built for the head widths the wrappers accept (up to
    ``FLASH_MHA_MAX_HEAD_DIM``, ``test_sources_instantiate_every_head_
    dim_bucket``), export the C entry points ``ops.cuda_kernels`` loads
    and the dynamic shared-memory query chip_smoke.py's resource report
    calls, and return cudaGetLastError() after each launch."""
    import inspect

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    _, csrc = fake
    src = (csrc / f"{source}.cu").read_text()
    text, headers = _with_headers(csrc, source)
    assert headers[-1] == "tensor_core.cuh"  # directly or through the
    assert len(headers) <= 2                 # forward body's header
    assert ck.HEAD_DIM_BUCKETS[-1] == ck.FLASH_MHA_MAX_HEAD_DIM
    assert f"kMaxHeadDim = {ck.FLASH_MHA_MAX_HEAD_DIM};" in text
    assert "constexpr int D = 64;" not in text
    assert "return cudaGetLastError();" in text
    assert f'extern "C" int {smem}' in src
    wrappers = inspect.getsource(ck)
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
        assert f'"{entry}"' in wrappers or "flash_mha_packed_bwd_{part}" \
            in wrappers
    assert _build.build([source])[source] > 0


@pytest.mark.parametrize("source,entries,loads", [
    ("flash_attention_partial", ("flash_attention_partial_fwd",),
     ('_load("flash_attention_partial", "flash_attention_partial_fwd"',)),
    ("flash_attention_partial_bwd",
     ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
     ('name = f"flash_attention_bwd_{part}"',
      '_load("flash_attention_partial_bwd", name')),
])
def test_flash_attention_partial_sources_export_the_wrappers_entry_points(
        fake, source, entries, loads):
    """csrc/flash_attention_partial.cu (through the forward body,
    attention_fwd.cuh) and its backward include the shared tensor-core
    header; both export the C entry
    points ``ops.cuda_kernels`` loads, take the key offset as an int
    argument, return cudaGetLastError() and take head widths up to the
    wrappers' limit; each counts its launches, and editing one rebuilds
    it alone."""
    import inspect

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    _, csrc = fake
    assert source in _build.SOURCES
    src = (csrc / f"{source}.cu").read_text()
    text, headers = _with_headers(csrc, source)
    assert headers[-1] == "tensor_core.cuh"
    assert "return cudaGetLastError();" in text
    assert f"kMaxHeadDim = {ck.FLASH_MHA_MAX_HEAD_DIM}" in text
    assert "int kv_offset" in src
    wrappers = inspect.getsource(ck)
    assert all(text in wrappers for text in loads)
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
    for name in ("flash_attention_partial", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert name in ck.LAUNCHES
    before = {n: _build._target(n) for n in _build.SOURCES}
    (csrc / f"{source}.cu").write_text(src + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == [source]
    assert _build.build([source])[source] > 0


@pytest.mark.parametrize("dp", (32, 64, 96, 128))
@pytest.mark.parametrize("source", [
    "flash_mha_packed", "flash_mha_packed_bwd", "flash_mha", "flash_mha_bwd",
    "flash_attention_partial", "flash_attention_partial_bwd",
    "paged_attention_decode", "paged_attention_decode_quant",
    "paged_attention_verify"])
def test_sources_instantiate_every_head_dim_bucket(source, dp):
    """Every attention kernel dispatches each head width up to
    ``FLASH_MHA_MAX_HEAD_DIM`` to a bucket of ``HEAD_DIM_BUCKETS``: the
    tensor-core kernels through ``launch_dp<T, DP>`` (``D <= DP``), the
    paged kernels through ``paged::with_head_dim`` (``Int<DP>``, the
    exact width unmasked, a narrower one Ragged), which every paged
    launcher calls, so a verify row and the decode step run one
    instantiation of their shared body."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    assert dp in ck.HEAD_DIM_BUCKETS
    src = (_build._CSRC / f"{source}.cu").read_text()
    if source.startswith("paged_attention"):
        hdr = (_build._CSRC / "paged_attention.cuh").read_text()
        assert f"kMaxHeadDim = {ck.FLASH_MHA_MAX_HEAD_DIM};" in hdr
        assert f"D == {dp} ? launch(Int<{dp}>{{}}, false_type{{}})" in hdr
        assert f"launch(Int<{dp}>{{}}, true_type{{}})" in hdr
        assert "paged::with_head_dim(D, [&](auto dp, auto ragged)" in src
        assert "case 64" not in src and "D != 64" not in src
    else:
        flat = " ".join(src.split())
        call = f"launch_dp<T, {dp}"
        if dp < ck.FLASH_MHA_MAX_HEAD_DIM:
            assert any(f"if ({d} <= {dp}) return {p}{call}" in flat
                       for d in ("D", "a.D") for p in ("", "fwd::")), \
                f"{source}: no launch_dp<T, {dp}> for its bucket"
        else:
            assert call in flat
        text = _with_headers(_build._CSRC, source)[0]
        assert f"Cfg<T, {dp}>::" in text  # its shared-memory query


PAGED = ("paged_attention_decode", "paged_attention_decode_quant",
         "paged_attention_verify")


def _paged_text(source):
    """A paged launcher's source with whitespace collapsed, and the shared
    header's."""
    flat = lambda t: " ".join(t.split())  # noqa: E731
    return (flat((_build._CSRC / f"{source}.cu").read_text()),
            flat((_build._CSRC / "paged_attention.cuh").read_text()))


def test_paged_entry_points_launch_one_kernel_template_decode_at_w1():
    """B2, B3 and B4 launch one kernel template, ``paged::attend_kernel``,
    through ``paged::launch_attend``: the decode entry points at W = 1
    over ``lengths`` (add 0), the verify entry points at W over ``start``
    (add 1, row w at start + 1 + w).  The old per-row body and its grid
    (B, H, W) are gone, and W = 1 picks the one-row instantiation."""
    _, hdr = _paged_text(PAGED[0])
    assert hdr.count("__global__") == 1
    assert "attend_kernel(const TQ* __restrict__ q" in hdr
    assert "decode_kernel" not in hdr and "verify_kernel" not in hdr
    assert "if (W == 1) return launch_rows<TQ, DP, 1>(" in hdr
    assert "return launch_rows<TQ, DP, WC>(" in hdr
    for source in PAGED:
        src, _ = _paged_text(source)
        assert "__global__" not in src and "<<<" not in src
        assert "dim3 grid" not in src
        calls = re.findall(r"paged::launch_attend<[^;]*;", src)
        assert len(calls) == 1  # verify: one for both readers
        want = "start, 1, o, B, W, H, D, KVB, MB" \
            if source.endswith("verify") \
            else "lengths, 0, o, B, 1, H, D, KVB, MB"
        assert want in calls[0]


@pytest.mark.parametrize("dp", (32, 64, 96, 128))
@pytest.mark.parametrize("source,readers", [
    ("paged_attention_decode", ("RawPages",)),
    ("paged_attention_decode_quant", ("QuantPages",)),
    ("paged_attention_verify", ("RawPages", "QuantPages"))])
def test_paged_sources_instantiate_every_bucket_for_their_readers(
        source, readers, dp):
    """Each paged launcher builds its page readers and hands them to the
    one head-width dispatch, which instantiates every bucket (the exact
    width and a narrower, ragged one); the shared-memory query covers
    every bucket at every pool element size (4, 2 and 1 bytes)."""
    src, hdr = _paged_text(source)
    for reader in readers:
        assert f"const paged::{reader}<" in src
    assert src.count("paged::with_head_dim(D, [&](auto dp, auto ragged)") \
        == 1
    assert f"D == {dp} ? launch(Int<{dp}>{{}}, false_type{{}})" in hdr
    assert f"launch(Int<{dp}>{{}}, true_type{{}})" in hdr
    for es in (4, 2, 1):
        assert f"PAGED_SMEM({dp}, {es})" in hdr
    assert f"{source}_smem_bytes" in src


def test_paged_cluster_size_is_a_constant():
    """The paged kernels' cluster is NC CTAs, a constant of the header that
    depends on no argument: the launch sets the cluster dimension to NC
    and the grid to NC CTAs a (stream, head), and each library reports
    NC.  chip_smoke.py's partition edges use the header's NC and NW."""
    import chip_smoke

    _, hdr = _paged_text(PAGED[0])
    nc, nw, wc = (re.search(rf"constexpr int {c} = (\d+);", hdr)
                  for c in ("NC", "NW", "WC"))
    assert nc and nw and wc and int(nc.group(1)) == 8  # the portable size
    assert (chip_smoke.PAGED_NC, chip_smoke.PAGED_NW, chip_smoke.PAGED_WC) \
        == tuple(int(x.group(1)) for x in (nc, nw, wc))
    assert "attr[0].val.clusterDim.x = NC;" in hdr
    assert "attr[0].val.clusterDim.y = 1;" in hdr
    assert "cfg.gridDim = dim3(NC * B, H, 1);" in hdr
    assert hdr.count("clusterDim.x") == 1
    assert "NonPortableClusterSizeAllowed" not in hdr
    for source in PAGED:
        src, _ = _paged_text(source)
        assert f"int {source}_cluster_size() {{ return paged::NC; }}" in src


USER_SOURCE = "__global__ void k(const float* x, float* y, long long n) {}\n"


def test_user_source_builds_under_a_hash_of_its_text_and_flags(fake):
    """``build_source``: the same text and flags give the same library
    and build once; another text or another flag gives a new one; the
    flags reach nvcc after the sm_90a ones."""
    record, _ = fake
    target = _build._source_target("usr", USER_SOURCE, ())
    assert target.name.startswith("libuser_usr-") and \
        target.name.endswith(".so")
    assert _build._source_target("usr", USER_SOURCE, ()) == target
    assert _build.build_source("usr", USER_SOURCE) > 0
    assert target.exists()
    assert _build.build_source("usr", USER_SOURCE) == 0.0
    assert len(record.read_text().splitlines()) == 1
    edited = USER_SOURCE + "// edited\n"
    assert _build._source_target("usr", edited, ()) != target
    assert _build._source_target("usr", USER_SOURCE, ("-lineinfo",)) != target
    assert _build._source_target("other", USER_SOURCE, ()) != target
    assert _build.build_source("usr", USER_SOURCE, ("-lineinfo",)) > 0
    calls = record.read_text().splitlines()
    assert len(calls) == 2 and "arch=compute_90a,code=sm_90a" in calls[1]
    assert calls[1].index("sm_90a") < calls[1].index("-lineinfo")
    # several sources compile at once
    done = _build.build_sources([("a", USER_SOURCE + "//a\n", ()),
                                 ("b", USER_SOURCE + "//b\n", ())])
    assert sorted(done) == ["a", "b"] and all(t > 0 for t in done.values())
    with pytest.raises(MXNetError, match="letters, digits and _ only"):
        _build.build_source("no/slash", USER_SOURCE)


def test_kernels_and_user_sources_build_in_one_call(fake):
    """``build(names, sources=...)``: the kernels of ``csrc/`` and user
    sources compile together, a user source keyed ``user_<key>``; a
    second call compiles nothing."""
    record, _ = fake
    names = ["nms", "lstm_scan"]
    done = _build.build(names, sources=[("nms", USER_SOURCE, ()),
                                        ("b", USER_SOURCE + "//b\n", ())])
    assert sorted(done) == ["lstm_scan", "nms", "user_b", "user_nms"]
    assert all(t > 0 for t in done.values())
    assert len(record.read_text().splitlines()) == 4
    assert _build._source_target("nms", USER_SOURCE, ()).exists()
    assert _build._target("nms").exists()
    again = _build.build(names, sources=[("nms", USER_SOURCE, ())])
    assert again == {"nms": 0.0, "lstm_scan": 0.0, "user_nms": 0.0}
    assert len(record.read_text().splitlines()) == 4


def test_user_source_that_fails_raises_with_the_compiler_output(fake):
    with pytest.raises(MXNetError, match="stand-in compile failure"):
        _build.build_source("broken", "FAIL\n")
    left = [p.name for p in _build.BUILD_DIR.iterdir()]
    assert not [n for n in left if n.endswith((".tmp", ".log", ".so"))]


def test_user_kernel_loads_its_library_once(fake, monkeypatch):
    """``library_for_source`` builds and loads a source once a process;
    a kernel's entry point comes from that library."""
    loads = []

    class Lib:
        def __init__(self, path):
            loads.append(path)

    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    monkeypatch.setattr(_build, "_user_libs", {})
    first = _build.library_for_source("once", USER_SOURCE)
    assert _build.library_for_source("once", USER_SOURCE) is first
    assert len(loads) == 1 and loads[0].endswith(".so")


def test_missing_nvcc_raises_at_the_first_cuda_build_not_before(
        tmp_path, monkeypatch):
    """Without nvcc the port imports, registers a user CUDA op and runs
    it on CPU tensors; the first build (a CUDA call) raises MXNetError."""
    import torch
    import torch.utils.cpp_extension as cpp_ext

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import rtc

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_user_libs", {})
    name = "nonvcc_" + tmp_path.name.replace("-", "_")[-12:]
    op = rtc.cuda_op(name, USER_SOURCE, "k", plain=lambda x: x + 1.0)
    out = getattr(mt.nd, name)(mt.nd.ones((2,), ctx=mt.cpu()))
    assert out.asnumpy().tolist() == [2.0, 2.0]
    with torch.no_grad():
        assert op.kernel(torch.zeros(1)).tolist() == [1.0]
    with pytest.raises(MXNetError, match="nvcc not found"):
        op.kernel._load()
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.build([], sources=[(name, op.kernel.text, ())])
