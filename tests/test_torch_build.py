"""The kernels' build naming on the CPU: what ``build.source_hash`` reads.

A library is built once into ``kernels/_build/`` under a name hashed from
its sources, the ``.cuh`` headers beside them and the headers every package
shares (``kernels/csrc/``, where ``wgmma.cuh`` lives), so that an edited
header never loads a stale library.  The build itself needs nvcc and runs
on the card only."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

KERNELS = Path(build.__file__).resolve().parent
SOURCES = sorted(KERNELS.glob("*/csrc/*.cu"))


def _copy(tmp_path, text="// a header\n"):
    """A source and its own header in one directory, a shared header in another."""
    own, shared = tmp_path / "pkg" / "csrc", tmp_path / "csrc"
    own.mkdir(parents=True)
    shared.mkdir()
    (own / "k.cu").write_text('#include "../../csrc/s.cuh"\n')
    (own / "o.cuh").write_text("// own\n")
    (shared / "s.cuh").write_text(text)
    return own / "k.cu", own / "o.cuh", shared


@pytest.mark.parametrize("which", ["shared", "own", "source"])
def test_every_file_a_build_reads_names_it(tmp_path, monkeypatch, which):
    src, own, shared = _copy(tmp_path)
    monkeypatch.setattr(build, "SHARED_CSRC", shared)
    before = build.source_hash([src])
    edited = {"shared": shared / "s.cuh", "own": own, "source": src}[which]
    edited.write_text(edited.read_text() + "// edited\n")
    assert build.source_hash([src]) != before


def test_the_hash_is_the_same_for_the_same_files(tmp_path, monkeypatch):
    src, _, shared = _copy(tmp_path)
    monkeypatch.setattr(build, "SHARED_CSRC", shared)
    assert build.source_hash([src]) == build.source_hash([Path(str(src))])
    assert len(build.source_hash([src])) == 16


def test_the_shared_directory_holds_the_wgmma_header():
    """One copy of the wgmma building blocks, shared by the flash and SSD kernels."""
    assert build.SHARED_CSRC == KERNELS / "csrc"
    assert (build.SHARED_CSRC / "wgmma.cuh").is_file()
    assert not list(KERNELS.glob("*/csrc/wgmma.cuh"))


@pytest.mark.parametrize("src", SOURCES, ids=lambda p: p.name)
def test_every_quoted_include_resolves_beside_its_source(src):
    """nvcc looks a quoted include up beside the including file first: each
    one a source names must be there, and every header it reaches is hashed."""
    hashed = {h.resolve() for d in (src.parent, build.SHARED_CSRC) for h in d.glob("*.cuh")}
    for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
        path = (src.parent / inc).resolve()
        assert path.is_file(), (src, inc)
        assert path in hashed, (src, inc)


@pytest.mark.parametrize("sources", [ssd_ops.SOURCES, fa_ops.SOURCES], ids=["ssd_scan", "flash"])
def test_the_wgmma_sources_are_in_their_libraries(sources):
    names = {Path(s).name for s in sources}
    users = {s.name for s in SOURCES if "csrc/wgmma.cuh" in s.read_text() and s.name in names}
    assert users, names
    assert "ssd_scan_bwd_wgmma.cu" in names or "flash_attention.cu" in names
