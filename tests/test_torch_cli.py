"""The port's two command-line tools (zopfli_tpu_torch.cli and
zopfli_tpu_torch.png.cli) against the JAX package's, and their rule
that a missing card or a failed device call is never hidden."""

import io
import zlib

import numpy as np
import pytest
import torch

import zopfli_tpu_torch as zt
from zopfli_tpu import cli as ref_cli
from zopfli_tpu_torch import cli
from zopfli_tpu_torch.png import cli as pcli
from zopfli_tpu_torch.png import codec

PIL = pytest.importorskip("PIL.Image")

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

DATA = (b"hello cli world " * 40 + bytes(range(256)) * 3
        + np.random.default_rng(9).integers(0, 8, 700, np.uint8).tobytes())
EXT = {"gzip": ".gz", "zlib": ".zlib", "deflate": ".deflate"}


class _Stdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):          # print() of the usage text
        return len(s)


def _run(main, argv, monkeypatch):
    out = _Stdout()
    with monkeypatch.context() as mp:
        mp.setattr("sys.stdout", out)
        rc = main(argv)
    return rc, out.buffer.getvalue()


@pytest.mark.parametrize("fmt", sorted(EXT))
def test_native_files_and_stdout_identical_to_reference(fmt, tmp_path,
                                                        monkeypatch):
    outs = {}
    for name, main in (("port", cli.main), ("ref", ref_cli.main)):
        d = tmp_path / name
        d.mkdir()
        p = d / "x.bin"
        p.write_bytes(DATA)
        args = ["--engine=native", "--i5", f"--{fmt}"]
        assert main(args + [str(p)]) == 0
        rc, stdout = _run(main, args + ["-c", str(p)], monkeypatch)
        assert rc == 0
        outs[name] = ((d / ("x.bin" + EXT[fmt])).read_bytes(), stdout)
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == outs["port"][1]
    wbits = {"gzip": 31, "zlib": 15, "deflate": -15}[fmt]
    assert zlib.decompress(outs["port"][0], wbits) == DATA


@pytest.mark.parametrize("argv,rc", [
    (["--engine=native", "--splitlast", "--i2"], 0),
    (["--i0", "f"], 1),
    ([], 1),
    (["--bogus", "f"], 1),
    (["--engine=tpu", "f"], 1),
    (["--device=tpu", "f"], 1),
])
def test_flags(argv, rc, tmp_path, monkeypatch):
    p = tmp_path / "z.txt"
    p.write_bytes(b"abcabcabc")
    if rc == 0:
        argv = argv + [str(p)]
    assert _run(cli.main, argv, monkeypatch)[0] == rc
    assert (tmp_path / "z.txt.gz").exists() == (rc == 0)


def test_device_cpu_equals_compress(tmp_path, monkeypatch):
    p = tmp_path / "d.bin"
    p.write_bytes(DATA)
    rc, out = _run(cli.main, ["--engine=device", "--device=cpu", "--i2",
                              "--zlib", "-c", str(p)], monkeypatch)
    assert rc == 0
    assert out == zt.compress(DATA, "zlib", zt.Options(device="cpu",
                                                       numiterations=2))


def _png(arr, mode="RGB"):
    buf = io.BytesIO()
    PIL.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


def _images():
    rng = np.random.default_rng(4)
    stripes = np.zeros((16, 16, 3), np.uint8)
    stripes[::2] = 128
    rgba = rng.integers(0, 256, (12, 10, 4)).astype(np.uint8)
    rgba[:4, :, 3] = 0
    return {"a.png": _png(stripes), "b.png": _png(rgba, "RGBA")}


def _rgba(png):
    return codec.decode(png)[0]


def test_png_cli_device_cpu_pixel_identical(tmp_path, capsys):
    imgs = _images()
    for name, png in imgs.items():
        (tmp_path / name).write_bytes(png)
    src, dst = tmp_path / "a.png", tmp_path / "out.png"
    assert pcli.main(["--device=cpu", "--iterations=2", "-y", str(src),
                      str(dst)]) == 0
    assert np.array_equal(_rgba(dst.read_bytes()), _rgba(imgs["a.png"]))
    assert pcli.main(["--device=cpu", "--iterations=2", "--prefix=z_"]
                     + [str(tmp_path / n) for n in imgs]) == 0
    for name, png in imgs.items():
        out = (tmp_path / ("z_" + name)).read_bytes()
        assert np.array_equal(_rgba(out), _rgba(png))
    assert "keeping original" not in capsys.readouterr().err


def _bad_image_keeps_original(good, bad, tmp_path, capsys):
    (tmp_path / "good.png").write_bytes(good)
    (tmp_path / "bad.png").write_bytes(bad)
    assert pcli.main(["--device=cpu", "--iterations=2", "--prefix=o_",
                      str(tmp_path / "bad.png"),
                      str(tmp_path / "good.png")]) == 0
    assert "bad.png: decoding failed" in capsys.readouterr().err
    assert (tmp_path / "o_bad.png").read_bytes() == bad
    assert np.array_equal(_rgba((tmp_path / "o_good.png").read_bytes()),
                          _rgba(good))


def test_png_cli_bad_image_keeps_original(tmp_path, capsys):
    good = _images()["a.png"]
    bad = good[:40] + b"\x00" * 30 + good[70:]    # IDAT bytes broken
    _bad_image_keeps_original(good, bad, tmp_path, capsys)


def _with_ihdr(png, bitdepth=None, colortype=None):
    """png with IHDR's bit depth or colortype replaced, CRC fixed."""
    b = bytearray(png)
    if bitdepth is not None:
        b[24] = bitdepth
    if colortype is not None:
        b[25] = colortype
    b[29:33] = zlib.crc32(bytes(b[12:29])).to_bytes(4, "big")
    return bytes(b)


@pytest.mark.parametrize("header", ["colortype5", "gray_bitdepth3"])
def test_png_cli_malformed_header_keeps_original(header, tmp_path, capsys):
    """A colortype or bit depth that PNG does not define makes the codec
    raise KeyError: that image keeps its original, the others are
    written."""
    good = _images()["a.png"]
    if header == "colortype5":
        bad = _with_ihdr(good, colortype=5)
    else:
        gray = _png(np.zeros((16, 16), np.uint8), "L")
        bad = _with_ihdr(gray, bitdepth=3)
    with pytest.raises(KeyError):
        codec.decode(bad)
    _bad_image_keeps_original(good, bad, tmp_path, capsys)


def test_png_cli_device_error_is_not_swallowed(tmp_path, monkeypatch,
                                               capsys):
    def launch_failed(*a, **k):
        raise RuntimeError("scan kernel launch failed: CUDA error 719")
    monkeypatch.setattr(zt, "compress_many", launch_failed)
    src = tmp_path / "a.png"
    src.write_bytes(_images()["a.png"])
    with pytest.raises(RuntimeError, match="launch failed"):
        pcli.main(["--device=cpu", "-y", str(src), str(tmp_path / "o.png")])
    assert "keeping original" not in capsys.readouterr().err
    assert not (tmp_path / "o.png").exists()


def test_default_device_fails_without_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tmp_path / "x.txt"
    p.write_bytes(DATA)
    assert cli.main([str(p)]) != 0
    assert not (tmp_path / "x.txt.gz").exists()
    src = tmp_path / "a.png"
    src.write_bytes(_images()["a.png"])
    assert pcli.main([str(src), str(tmp_path / "o.png")]) != 0
    assert not (tmp_path / "o.png").exists()
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "keeping original" not in err
