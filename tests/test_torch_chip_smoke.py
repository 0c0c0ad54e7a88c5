"""``chip_smoke.py`` phase 1 reads each kernel's spills from the nvcc
output kept beside its built library, so the check holds when the
libraries were built by an earlier process (a second run in the same
checkout, after the card tests or ``chip_compare.py``) as when this one
built them.  ``cuobjdump`` and ``nvcc`` exist only on the GPU machine:
here the HMMA counts are given and the libraries are empty files.
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def ptxas_text(fns, spill):
    return "".join(
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        f"spill loads\n"
        f"ptxas info    : Used 128 registers\n" for fn in fns)


@pytest.fixture
def built(tmp_path, monkeypatch):
    """Every MMA_KERNELS source built earlier: a library and its nvcc
    output in the build directory, one mangled function per fragment with
    HMMA unless its kind is "cuda"; returns a writer of one source's
    output at a given spill."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    counts = {source: {f"_Z{len(frag)}{frag}v": 0 if kind == "cuda" else 8
                       for frag, kind in kinds.items()}
              for source, kinds in chip_smoke.MMA_KERNELS.items()}
    monkeypatch.setattr(chip_smoke, "hmma_counts", counts.__getitem__)

    def write(source, spill=0):
        _build._lib_path(source).touch()
        _build._log_path(source).write_text(ptxas_text(counts[source],
                                                       spill))
    for source in counts:
        write(source)
    return write


def test_check_hmma_reads_spills_of_an_earlier_build(built, capsys):
    chip_smoke.check_hmma()
    out = capsys.readouterr().out
    assert "flash_tf32x3_kernel" in out
    assert "spill bytes None" not in out


def test_check_hmma_fails_on_a_spilling_tf32_kernel(built):
    built("mlstm_chunkwise", spill=8)
    with pytest.raises(AssertionError, match="spills 16 bytes"):
        chip_smoke.check_hmma()


def test_check_hmma_fails_without_the_nvcc_output(built):
    _build._log_path("decode_attention").unlink()
    with pytest.raises(AssertionError, match="spills None bytes"):
        chip_smoke.check_hmma()


def test_build_all_rebuilds_a_library_without_its_nvcc_output(built,
                                                              monkeypatch):
    _build._log_path("flash_attention").unlink()
    started = []
    monkeypatch.setattr(_build, "_start",
                        lambda name: started.append(name) or (None, ""))
    monkeypatch.setattr(_build, "_finish", lambda name, proc, tmp: None)
    _build.build_all(list(chip_smoke.MMA_KERNELS))
    assert started == ["flash_attention"]


class _Done:
    returncode = 0

    def communicate(self):
        return ptxas_text(["_Z1fv"], 0), None


def test_finish_keeps_the_nvcc_output_beside_the_library(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    tmp = tmp_path / "tmp.so"
    tmp.write_bytes(b"lib")
    _build._finish("rglru_scan", _Done(), str(tmp))
    assert _build._lib_path("rglru_scan").read_bytes() == b"lib"
    assert _build.ptxas_output("rglru_scan") == ptxas_text(["_Z1fv"], 0)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [_build._lib_path("rglru_scan").name,
         _build._log_path("rglru_scan").name])
