"""``chip_compare.py merge-share`` times the decode kernels with their
merge skipped by text patches of the CUDA sources: the patches must find
the merge in the repository's sources, and a source where they find
nothing must stop the measurement instead of timing the kernel as it is.
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
import chip_compare  # noqa: E402


def test_skip_merge_patches_every_decode_source(tmp_path):
    dest = tmp_path / "csrc"
    chip_compare.skip_merge_sources(CSRC, dest)
    changed = [p.name for p in sorted(dest.iterdir())
               if p.read_text() != (CSRC / p.name).read_text()]
    assert changed, "no source was patched"
    for name in changed:
        text = (dest / name).read_text()
        assert any(b in text for _, b in chip_compare.SKIP_MERGE), name
    headers = {p.name for p in CSRC.glob("*.cuh")}
    for name in chip_compare.DECODE_SOURCES:
        assert set(changed) & ({f"{name}.cu"} | headers), name


def test_skip_merge_raises_when_the_merge_is_not_found(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for p in CSRC.iterdir():
        text = p.read_text()
        for a, _ in chip_compare.SKIP_MERGE:
            text = text.replace(a, a.replace("return", "return /**/"))
        (src / p.name).write_text(text)
    with pytest.raises(RuntimeError, match="merge was not found"):
        chip_compare.skip_merge_sources(src, tmp_path / "dest")
