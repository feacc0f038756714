"""repro_torch.kernels._build: the nvcc driver, exercised with a stand-in
compiler (a script that writes its ``-o`` target), so the build logic —
one compile per source, one link, the source-hash name, reuse, failure —
is checked without the CUDA toolkit."""
import sys

import pytest

from repro_torch.kernels import _build

_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if {fail!r} and "-c" in args and args[args.index("-c") + 1].endswith({fail!r}):
    print("error: refused")
    sys.exit(1)
open(args[args.index("-o") + 1], "w").write("built")
print("compiled" if "-c" in args else "linked")
"""


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    def install(fail=""):
        bindir = tmp_path / "bin"
        bindir.mkdir(exist_ok=True)
        nvcc = bindir / "nvcc"
        nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, fail=fail))
        nvcc.chmod(0o755)
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    return install


def test_build_compiles_each_source_links_once_and_reuses(fake_nvcc):
    fake_nvcc()
    lib = _build.build()
    assert lib.read_text() == "built"
    assert lib.name.startswith("librepro_torch_")
    log = (lib.parent / "build.log").read_text()
    for src in ("join.cu", "jaccard.cu"):
        assert f"== {src}\ncompiled" in log
    mtime = lib.stat().st_mtime_ns
    assert _build.build() == lib and lib.stat().st_mtime_ns == mtime
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, "build.log"])               # no temporary left behind


def test_build_failure_raises_with_compiler_output(fake_nvcc):
    fake_nvcc(fail="join.cu")
    with pytest.raises(RuntimeError, match="nvcc failed on join.cu"):
        _build.build()
    assert not _build.library_path().exists()


def test_every_entry_point_has_a_signature():
    text = "".join(p.read_text() for p in _build._sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
    assert text.count('extern "C" int ') == len(_build.SIGNATURES)
