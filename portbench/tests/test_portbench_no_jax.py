import sys

from portbench import run


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("zopfli_tpu_torch", "zopfli_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jax", "jaxlib", "flax", "zopfli_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zopfli_tpu.ops.seed", object())
    assert run.forbidden_modules() == ["zopfli_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "zopfli_tpu"]


def test_harness_imports_neither_jax_nor_the_jax_package():
    import subprocess
    code = ("import sys; sys.path.insert(0, '.'); "
            "import portbench.run, portbench.control; "
            "import zopfli_tpu_torch, zopfli_tpu_torch.png.optimize; "
            "print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, check=True)
    assert out.stdout.strip() == "[]"
