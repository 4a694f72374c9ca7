"""`python -m h263_tpu_torch` against `python -m h263_tpu`: on the same
inputs the two CLIs write byte-equal PPM frames, npz archives with equal
members (the zip's own timestamps aside) and the same `info` lines; the
port's runs on the CPU here (`--device cpu`).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.__main__ import main as jax_main  # noqa: E402
from h263_tpu_torch.__main__ import main as port_main  # noqa: E402
from h263_tpu_torch.io.flv import iter_flv_video_tags  # noqa: E402
from h263_tpu_torch.testing import corpora as C  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
QCIF = FIX / "ffmpeg_flv1_qcif.flv"
ODD = FIX / "ffmpeg_flv1_odd.flv"


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("src,extra", [
    (QCIF, ["--max-frames", "5"]),
    (ODD, ["--deblock", "on"]),
    (ODD, ["--deblock", "off", "--max-frames", "4"]),
])
def test_decode_writes_the_same_ppm_files(tmp_path, capsys, src, extra):
    a, b = tmp_path / "jax", tmp_path / "port"
    ja = _run(jax_main, ["decode", str(src), "-o", str(a), *extra], capsys)
    pa = _run(port_main, ["decode", str(src), "-o", str(b), "--device",
                          "cpu", *extra], capsys)
    assert ja[0] == pa[0] == 0
    assert ja[1].replace(str(a), "D") == pa[1].replace(str(b), "D")
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("standard", [False, True])
def test_decode_writes_the_same_npz_members(tmp_path, capsys, standard):
    """A raw elementary stream (Sorenson or standard) to YUV planes."""
    frames = (C.std_qcif_corpus()[:4] if standard
              else C.rich_gop(2, 48, 32, 5))
    raw = tmp_path / "in.h263"
    raw.write_bytes(b"".join(frames))
    flag = ["--standard"] if standard else []
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jax_main(["decode", str(raw), "-o", str(a), "--fmt", "npz",
                     *flag]) == 0
    assert port_main(["decode", str(raw), "-o", str(b), "--fmt", "npz",
                      "--device", "cpu", *flag]) == 0
    capsys.readouterr()
    ja, pa = np.load(a / "frames.npz"), np.load(b / "frames.npz")
    assert sorted(ja.files) == sorted(pa.files)
    assert len(ja.files) == 3 * len(frames)
    for k in ja.files:
        assert ja[k].dtype == pa[k].dtype
        np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)


def test_decode_reports_errors_alike(tmp_path, capsys):
    tags = [t.payload for t in iter_flv_video_tags(QCIF.read_bytes())]
    raw = tmp_path / "broken.h263"
    raw.write_bytes(tags[0] + b"\x00\x00\x80\x02\xff" + b"".join(tags[1:3]))
    outs = []
    for main, dev in ((jax_main, []), (port_main, ["--device", "cpu"])):
        outs.append(_run(main, ["decode", str(raw), "-k", *dev], capsys))
    assert outs[0] == outs[1]
    assert "errored" in outs[0][1]


@pytest.mark.parametrize("argv", [
    ["info", str(QCIF)],
    ["info", str(ODD), "-v", "--max-frames", "6"],
])
def test_info_prints_the_same_lines(capsys, argv):
    assert _run(jax_main, argv, capsys) == _run(port_main, argv, capsys)


def test_info_of_a_standard_stream(tmp_path, capsys):
    raw = tmp_path / "std.h263"
    raw.write_bytes(b"".join(C.umv_corpus(176, 144, 3)))
    argv = ["info", str(raw), "--standard", "-v"]
    ja, pa = _run(jax_main, argv, capsys), _run(port_main, argv, capsys)
    assert ja == pa and ja[0] == 0 and "3 pictures" in ja[1]


def test_selftest_on_the_cpu(capsys):
    assert port_main(["selftest", "--device", "cpu"]) == 0
    assert "selftest OK" in capsys.readouterr().out


def test_module_entry_point_runs():
    """`python -m h263_tpu_torch info` in a fresh interpreter (no card
    needed); `decode` without a card raises rather than falling back."""
    proc = subprocess.run(
        [sys.executable, "-m", "h263_tpu_torch", "info", str(QCIF),
         "--max-frames", "2"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "2 pictures" in proc.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_main(["decode", str(QCIF), "--max-frames", "1"])
