"""``chip_compare.py merge-share`` times the decode kernels with their
merge skipped, and ``split-share`` the fp32 flash kernel with its K/V
3xTF32 splits skipped, by text patches of the CUDA sources: the patches
must find their text in the repository's sources, and a source where they
find nothing must stop the measurement instead of timing the kernel as it
is.  Both time the two builds in turns and restore the sources; the other
comparisons run each checkout in fresh processes, in turns.
"""
import re
import shutil
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


def test_skip_split_patches_the_flash_source(tmp_path):
    dest = tmp_path / "csrc"
    chip_compare.skip_split_sources(CSRC, dest)
    before = (CSRC / "flash_attention.cu").read_text()
    text = (dest / "flash_attention.cu").read_text()
    assert "b_small" in before and "__float_as_uint" in text
    assert not re.search(r"split_tf32\([^;]*b_big", text)
    for kept in ("a_big", "p_big"):     # Q's and P's splits stay
        assert (len(re.findall(rf"split_tf32\([^;]*{kept}", text))
                == len(re.findall(rf"split_tf32\([^;]*{kept}", before)) > 0)
    for p in CSRC.iterdir():
        if p.name != "flash_attention.cu":
            assert (dest / p.name).read_text() == p.read_text()


def test_skip_split_raises_when_a_split_is_not_found(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(CSRC, src)
    path = src / "flash_attention.cu"
    path.write_text(path.read_text().replace("b_big", "b_hi"))
    with pytest.raises(RuntimeError, match="no K or V split"):
        chip_compare.skip_split_sources(src, tmp_path / "dest")


def test_patched_times_alternates_builds_and_restores_the_sources(
        tmp_path, monkeypatch):
    import chip_smoke
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, iters: fn())
    csrc = _build.CSRC
    seen = []

    def patch(src, dest):
        assert src == csrc
        shutil.copytree(src, dest)

    def case():
        seen.append(_build.CSRC)
        return 2.0 if _build.CSRC == tmp_path / "p" else 1.0
    times = chip_compare.patched_times({"k": case}, patch, "p", 3)
    assert times == {"k": (1.0, 2.0, [1.0, 1.0], [2.0, 2.0])}
    assert seen == [csrc, tmp_path / "p", tmp_path / "p", csrc]
    assert _build.CSRC == csrc


SCRIPT = r"""
import json, os, sys
json.dump({"cwd": os.getcwd(), "argv": sys.argv[2:]}, open(sys.argv[1], "w"))
print("hello")
"""


def test_fresh_runs_from_the_tree_and_returns_its_result(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(chip_compare, "LOGDIR", tmp_path / "logs")
    tree = tmp_path / "tree"
    tree.mkdir()
    out, res = chip_compare.fresh(SCRIPT, tree, "run", 3, "x")
    assert out == "hello\n"
    assert res == {"cwd": str(tree.resolve()), "argv": ["3", "x"]}
    assert (tmp_path / "logs" / "run.log").read_text() == "hello\n"
    out, res = chip_compare.fresh("print('no result')", tree, "run")
    assert res is None      # the earlier run's result is not read back
    with pytest.raises(RuntimeError, match="bad failed"):
        chip_compare.fresh("raise SystemExit(3)", tree, "bad")


@pytest.mark.parametrize("other", [None, "parent"])
def test_in_turns_puts_this_checkout_between_the_other(tmp_path, other,
                                                       capsys):
    other = other and tmp_path / other
    calls = []
    runs = chip_compare.in_turns(other, lambda tree, label: calls.append(
        (tree, label)) or float(len(calls)))
    this = chip_compare.ROOT
    if other is None:
        assert calls == [(this, "this_1"), (this, "this_2")]
        assert runs == {"this": [1.0, 2.0]}
    else:
        assert calls == [(other, "other_1"), (this, "this_1"),
                         (this, "this_2"), (other, "other_2")]
        assert runs == {"other": [1.0, 4.0], "this": [2.0, 3.0]}
    means = chip_compare.print_means("[x] k", runs, lambda r: r)
    assert means == ({"other": 2.5, "this": 2.5} if other
                     else {"this": 1.5})
    line = capsys.readouterr().out
    want = ("this [2.0, 3.0] mean 2.50000 ms;" if other
            else "this [1.0, 2.0] mean 1.50000 ms;")
    assert line.startswith("[x] k:") and want in line


def test_fp32_kernels_parses_and_prints_every_row(tmp_path, monkeypatch,
                                                  capsys):
    """``fp32-kernels [--tree DIR]``: each checkout's rows by fresh
    processes in turns (DIR, this, this, DIR), one line of runs and means
    per row of FP32_ROWS and this checkout's mean over DIR's."""
    args = chip_compare.parser().parse_args(["fp32-kernels", "--tree",
                                             str(tmp_path)])
    assert args.cmd == "fp32-kernels" and args.tree == tmp_path
    assert chip_compare.parser().parse_args(["fp32-kernels"]).tree is None
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "smi", lambda: "card, 700.00 W")
    calls = []

    def fake(script, tree, label, *argv):
        assert script is chip_compare.FP32K and argv == (chip_compare.ROOT,)
        calls.append((tree, label))
        ms = 2.0 if tree == tmp_path else 1.0
        return "", {row: ms for row in chip_compare.FP32_ROWS}
    monkeypatch.setattr(chip_compare, "fresh", fake)
    chip_compare.fp32_kernels(tmp_path)
    this = chip_compare.ROOT
    assert calls == [(tmp_path, "fp32k_other_1"), (this, "fp32k_this_1"),
                     (this, "fp32k_this_2"), (tmp_path, "fp32k_other_2")]
    out = capsys.readouterr().out
    assert len(chip_compare.FP32_ROWS) == 12
    for row in chip_compare.FP32_ROWS:
        assert (f"[fp32-kernels] {row}: other [2.0, 2.0] mean 2.00000 ms; "
                f"this [1.0, 1.0] mean 1.00000 ms;") in out
        assert f"[fp32-kernels] {row}: this / other = 0.500" in out
    assert out.rstrip().endswith("card, 700.00 W")


@pytest.mark.parametrize("name", sorted(chip_compare.FLASH_ABLATIONS))
def test_flash_ablations_find_their_text_and_functions(tmp_path, name):
    """``flash-ablate`` must change what it says it changes: each source
    patch finds its text in the repository's flash source, and each
    replaced function exists in the wrapper's module."""
    import sys as _sys
    import repro_torch.kernels.flash_attention  # noqa: F401
    fa = _sys.modules["repro_torch.kernels.flash_attention"]
    patches, attr = chip_compare.FLASH_ABLATIONS[name]
    dest = tmp_path / "csrc"
    chip_compare.ablated_sources(patches, CSRC, dest)
    before = (CSRC / "flash_attention.cu").read_text()
    after = (dest / "flash_attention.cu").read_text()
    assert (after != before) == bool(patches)
    for old, new in patches:
        assert new in after
    if attr:
        assert callable(getattr(fa, attr[0]))
    assert patches or attr


def test_flash_ablation_raises_when_its_text_is_gone(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(CSRC, src)
    path = src / "flash_attention.cu"
    path.write_text(path.read_text().replace("ex2.approx", "ex2.exact"))
    patches, _ = chip_compare.FLASH_ABLATIONS["no-exp"]
    with pytest.raises(RuntimeError, match="was not found"):
        chip_compare.ablated_sources(patches, src, tmp_path / "dest")
