"""Rules of the port package: no JAX, no zopfli_tpu, device by request."""

import ast
import json
import os
import subprocess
import sys
import zlib

import pytest
import torch

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "zopfli_tpu_torch")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax_or_reference():
    files = _port_sources()
    assert len(files) >= 28
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"zopfli_tpu_torch/ops/devsplit.py",
            "zopfli_tpu_torch/ops/seed.py", "zopfli_tpu_torch/cli.py",
            "zopfli_tpu_torch/png/cli.py",
            "zopfli_tpu_torch/png/optimize.py", "zopfli_tpu_torch/ops/dp.py",
            "zopfli_tpu_torch/ops/engine.py", "zopfli_tpu_torch/ops/mega.py",
            "zopfli_tpu_torch/parallel/dist.py",
            "zopfli_tpu_torch/parallel/multihost.py"} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "zopfli_tpu"), (path, mod)


def test_import_and_compress_leave_jax_unloaded(tmp_path):
    code = (
        "import json, sys, zlib\n"
        "import zopfli_tpu_torch as zt\n"
        "data = b'hello hello hello world ' * 200\n"
        "out = zt.compress(data, 'gzip', zt.Options(device='cpu',"
        " numiterations=2))\n"
        "assert zlib.decompress(out, 31) == data\n"
        "outs = zt.compress_many([data, data[:99]], 'zlib',"
        " zt.Options(device='cpu', numiterations=2))\n"
        "assert [zlib.decompress(o) for o in outs] == [data, data[:99]]\n"
        "import numpy as np\n"
        "from zopfli_tpu_torch import cli\n"
        "from zopfli_tpu_torch.png import PNGOptions, codec, optimize\n"
        "from zopfli_tpu_torch.png import cli as pcli\n"
        "open('x.txt', 'wb').write(data)\n"
        "assert cli.main(['--device=cpu', '--i2', 'x.txt']) == 0\n"
        "assert zlib.decompress(open('x.txt.gz', 'rb').read(), 31) == data\n"
        "img = np.zeros((8, 8, 3), np.uint8)\n"
        "img[::2] = 200\n"
        "png = codec.encode(codec.EncodeSpec(img.reshape(8, 24), 8, 8, 8,"
        " 2), np.zeros(8, np.int64), deflater=lambda b: zlib.compress(b))\n"
        "open('a.png', 'wb').write(png)\n"
        "assert pcli.main(['--device=cpu', '--iterations=2', '-y', 'a.png',"
        " 'b.png']) == 0\n"
        "out = optimize(png, PNGOptions(device='cpu', num_iterations=2))\n"
        "for p in (out, open('b.png', 'rb').read()):\n"
        "    assert (codec.decode(p)[0] == codec.decode(png)[0]).all()\n"
        "from zopfli_tpu_torch.ops import dp, engine, mega\n"
        "assert callable(mega.mega_dispatch) and mega.MEGA_MIN > 0\n"
        "from zopfli_tpu_torch.parallel import dist, multihost\n"
        "arr = np.frombuffer(data, np.uint8)\n"
        "lit, dst = engine.DeviceBlockEngine(arr, 0, len(arr),"
        " device='cpu').squeeze_run(None, None)\n"
        "assert np.where(dst == 0, 1, lit).sum() == len(arr)\n"
        "bufs, mp, ie = dist.pack_blocks(arr, [(0, 2000), (2000, 4000)],"
        " 2048)\n"
        "cl, cd, cost, total = dist.sharded_pipeline(['cpu'] * 2, 2048)("
        "bufs, mp, ie, np.full((2, 288), 8.0, np.float32),"
        " np.full((2, 32), 5.0, np.float32))\n"
        "assert cl.shape == (2, 2049) and float(total) > 0\n"
        "mh = multihost.compress_multihost(data, 'gzip',"
        " zt.Options(device='cpu', numiterations=2))\n"
        "assert zlib.decompress(mh, 31) == data\n"
        "mods = [m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'zopfli_tpu.')) or m == 'zopfli_tpu']\n"
        "print(json.dumps(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_default_device_is_cuda_and_never_falls_back():
    import zopfli_tpu_torch as zt
    assert zt.Options().device == "cuda" and zt.Options().engine == "device"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zt.compress(b"abc" * 100, "gzip", zt.Options())


def test_native_engine_and_bad_options():
    import zopfli_tpu_torch as zt
    data = b"native engine round trip " * 300
    out = zt.compress(data, "zlib", zt.Options(engine="native",
                                              numiterations=3))
    assert zlib.decompress(out) == data
    with pytest.raises(ValueError):
        zt.compress(data, "gzip", zt.Options(engine="tpu", device="cpu"))
    with pytest.raises(ValueError):
        zt.compress(data, "bz2", zt.Options(device="cpu"))


def test_empty_gzip_is_twenty_bytes():
    import zopfli_tpu_torch as zt
    out = zt.compress(b"", "gzip", zt.Options(device="cpu"))
    assert len(out) == 20 and zlib.decompress(out, 31) == b""


def test_warmup_and_tracer_on_cpu():
    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch.utils.logging import Tracer
    opts = zt.Options(device="cpu", numiterations=2)
    assert zt.warmup(sizes=(3000,), options=opts) is None
    assert (3000, 2, "device", "cpu") in zt._WARMED
    tracer = Tracer()
    data = b"trace every block of this input " * 120
    out = zt.compress(data, "gzip", zt.Options(device="cpu", numiterations=2,
                                               tracer=tracer))
    assert zlib.decompress(out, 31) == data
    kinds = {r["kind"] for r in tracer.records}
    assert {"iteration", "block", "summary"} <= kinds
