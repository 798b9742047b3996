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


def test_failed_compile_raises_with_compiler_output(fake):
    _, csrc = fake
    (csrc / "flash_mha_packed.cu").write_text("FAIL\n")
    with pytest.raises(MXNetError, match="stand-in compile failure"):
        _build.build()
    # nothing half-written is left to be loaded later
    left = [p.name for p in _build.BUILD_DIR.iterdir()]
    assert not [n for n in left if n.endswith((".tmp", ".log"))]
    assert not [n for n in left if n.startswith("libflash_mha_packed")]


def test_unknown_source_is_refused(fake):
    with pytest.raises(MXNetError, match="unknown kernel source"):
        _build.build(["no_such_kernel"])
