"""The port's kernel build (``mxnet_tpu_torch/_build.py``) on the CPU,
with a stand-in for ``nvcc``: parallel builds, content-hashed library
names, reuse of a built library, and a failed compile that raises with
the compiler's output and leaves nothing half-written.  The real
compile runs on the card (``chip_smoke.py``)."""

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


def test_build_all_kernels_once_with_sm90a_flags(fake):
    record, _ = fake
    assert "flash_mha_packed_bwd" in _build.SOURCES  # the backward kernels
    for name in ("paged_attention_decode_quant", "paged_attention_verify"):
        assert name in _build.SOURCES  # quantized decode and verify
    assert "lstm_scan" in _build.SOURCES  # the LSTM recurrence
    for name in ("flash_mha", "flash_mha_bwd"):
        assert name in _build.SOURCES  # DotProductAttention's kernels
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
    loads and computes the IoU with round-to-nearest intrinsics (no
    contracted multiply-add); ``nms`` counts its launches and routes a
    CPU tensor to ``nms_plain``."""
    _, csrc = fake
    src = (csrc / "nms.cu").read_text()
    assert 'extern "C" int nms(' in src and ".cuh" not in src
    for op in ("__fmul_rn", "__fsub_rn", "__fadd_rn", "__fdiv_rn",
               "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert op in src
    assert "nms" in _build.SOURCES
    from mxnet_tpu_torch.ops import cuda_kernels as ck

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
    import torch

    from mxnet_tpu_torch.ops.detection import multibox_detection

    B, C, A = 2, 3, 12
    prob = torch.softmax(torch.randn(B, C, A), 1).to(torch.bfloat16)
    loc = torch.zeros(B, A * 4, dtype=torch.bfloat16)
    anchors = torch.rand(1, A, 4).to(torch.bfloat16)
    with pytest.raises(MXNetError, match="not ported"):
        multibox_detection(prob, loc, anchors)
    # without NMS the decode runs in any dtype
    rows = multibox_detection(prob, loc, anchors, nms_threshold=0)
    assert rows.dtype == torch.bfloat16 and rows.shape == (B, A, 6)


def test_no_code_path_catches_a_failed_launch():
    """The wrappers, the ops that call them and the imperative namespace
    that calls the ops hold no try statement, so a kernel that fails to
    build or launch on a CUDA tensor raises and never falls back to the
    plain version."""
    import ast
    import pathlib

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    for name in ("flash_mha", "flash_mha_bwd", "launch_flash_mha_bwd"):
        assert callable(getattr(ck, name))  # the B5 wrappers are scanned
    pkg = pathlib.Path(_build.__file__).parent
    for path in [pkg / "ops" / f"{name}.py" for name in
                 ("cuda_kernels", "attention", "rnn", "detection")] \
            + [pkg / "ndarray.py"]:
        tree = ast.parse(path.read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.name} has try statements at {tries}"


@pytest.mark.parametrize("source,entries,loads", [
    ("flash_mha", ("flash_mha_fwd",),
     ('_load("flash_mha", "flash_mha_fwd"',)),
    ("flash_mha_bwd", ("flash_mha_bwd_dq", "flash_mha_bwd_dkv"),
     ('name = f"flash_mha_bwd_{part}"', '_load("flash_mha_bwd", name')),
])
def test_flash_mha_sources_export_the_wrappers_entry_points(
        fake, source, entries, loads):
    """csrc/flash_mha.cu and flash_mha_bwd.cu stand alone, export the C
    entry points ``ops.cuda_kernels`` loads, return cudaGetLastError()
    and take head widths up to the wrappers' limit; each counts its
    launches, and editing one rebuilds it alone."""
    import inspect

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    _, csrc = fake
    assert source in _build.SOURCES
    src = (csrc / f"{source}.cu").read_text()
    assert ".cuh" not in src and "return cudaGetLastError();" in src
    assert f"kMaxHeadDim = {ck.FLASH_MHA_MAX_HEAD_DIM}" in src
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
