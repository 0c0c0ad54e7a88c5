"""``chip_smoke.py`` phase 1 reads each kernel's spills from the nvcc
output kept beside its built library, so the check holds when the
libraries were built by an earlier process (a second run in the same
checkout, after the card tests or ``chip_compare.py``) as when this one
built them; each kernel's tensor-core opcodes (HMMA, HGMMA, UTMALDG) are
held to its kind.  ``cuobjdump`` and ``nvcc`` exist only on the GPU
machine: here the opcode counts are given and the libraries are empty
files.
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


def sass_ops(kind):
    """Opcode counts a kernel of ``kind`` has when it is built right."""
    need, _ = chip_smoke.SASS_RULES[kind]
    return {op: 8 if op in need else 0 for op in chip_smoke.SASS_OPS}


@pytest.fixture
def built(tmp_path, monkeypatch):
    """Every MMA_KERNELS source built earlier: a library and its nvcc
    output in the build directory, one mangled function per fragment with
    the opcodes its kind needs (``sass_ops``); returns a writer of one
    source's output at a given spill."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    counts = {source: {f"_Z{len(frag)}{frag}v": sass_ops(kind)
                       for frag, kind in kinds.items()}
              for source, kinds in chip_smoke.MMA_KERNELS.items()}
    monkeypatch.setattr(chip_smoke, "sass_counts", counts.__getitem__)

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
    assert "8 HGMMA, 8 UTMALDG in _Z18flash_wgmma_kernelv (wgmma)" in out
    assert "spill bytes None" not in out


def test_check_hmma_fails_on_a_spilling_tf32_kernel(built):
    built("mlstm_chunkwise", spill=8)
    with pytest.raises(AssertionError, match="spills 16 bytes"):
        chip_smoke.check_hmma()


@pytest.mark.parametrize("ops", [{"HMMA": 8, "HGMMA": 0, "UTMALDG": 0},
                                 {"HMMA": 0, "HGMMA": 8, "UTMALDG": 0},
                                 {"HMMA": 4, "HGMMA": 8, "UTMALDG": 2}])
def test_check_hmma_fails_on_a_flash_kernel_off_wgmma_and_tma(built,
                                                              monkeypatch,
                                                              ops):
    """The bf16 flash kernel must run wgmma on tiles the TMA loaded, and no
    mma.sync: an mma.sync build, one without tensor-map loads, and one
    with both kinds of product all fail."""
    given = chip_smoke.sass_counts

    def counts(source):
        return {fn: (ops if "flash_wgmma" in fn else n)
                for fn, n in given(source).items()}
    monkeypatch.setattr(chip_smoke, "sass_counts", counts)
    with pytest.raises(AssertionError,
                       match="must have HGMMA and UTMALDG and no HMMA"):
        chip_smoke.check_hmma()


def test_check_hmma_fails_on_a_spilling_wgmma_kernel(built):
    built("flash_attention", spill=4)
    with pytest.raises(AssertionError, match="flash_wgmma_kernelv spills 8"):
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
