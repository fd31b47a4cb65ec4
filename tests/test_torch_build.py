"""The kernel build and load under threads: a first build of one source
reached from several threads at once runs one compiler and gives one
library path, and a first load configures one library.  The compiler is a
stub script (this machine has no nvcc); the sources are the repo's."""
import ctypes
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402

STUB = """#!{python}
import pathlib, sys, time
time.sleep(0.5)
out = sys.argv[sys.argv.index("-o") + 1]
pathlib.Path(out).write_bytes(b"lib")
with open({count!r}, "a") as f:
    f.write("run\\n")
"""


def _together(n, fn):
    """Run ``fn`` on ``n`` threads released at once; returns the results
    (every thread must finish within 30 s)."""
    start = threading.Barrier(n)
    out, errs = [None] * n, []

    def work(i):
        start.wait()
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs
    return out


def test_concurrent_first_build_compiles_once(tmp_path, monkeypatch):
    count = tmp_path / "runs.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, count=str(count)))
    stub.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    paths = _together(4, lambda: build.build(ta.SOURCE))
    assert count.read_text().splitlines() == ["run"]
    assert len(set(paths)) == 1 and paths[0].read_bytes() == b"lib"
    assert not list((tmp_path / "_build").glob("*.tmp"))
    # built: a later call compiles nothing
    assert build.build(ta.SOURCE) == paths[0]
    assert count.read_text().splitlines() == ["run"]


def test_concurrent_first_load_configures_once(tmp_path, monkeypatch):
    """``build.load`` from four threads: one build, one ``CDLL``, one
    ``configure`` before any caller sees the library."""
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build", lambda src: tmp_path / "lib.so")
    opened, configured = [], []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)
            self.ready = False
            time.sleep(0.1)             # a load takes a while

    def configure(lib):
        configured.append(lib)
        lib.ready = True

    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    libs = _together(4, lambda: build.load("x.cu", configure))
    assert len(opened) == 1 and len(configured) == 1
    assert all(lib is libs[0] and lib.ready for lib in libs)


def _tool(name):
    """``tools/<name>.py`` as a module (a script, not part of the
    package)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_HD96 = _tool("hd96_width")


@pytest.mark.parametrize("variant", sorted(_HD96.EDITS))
def test_hd96_variant_edits_apply_to_the_sources(variant):
    """Each of ``tools/hd96_width.py``'s variants is the kernels' source
    with its edits: every text an edit replaces is in the current source
    (where one is not, the tool fails at its build on the card), and every
    edit changes it."""
    for src, pairs in _HD96.EDITS[variant].items():
        text = (build.CSRC / src).read_text()
        for old, new in pairs:
            assert old in text, (variant, src, old)
            edited = text.replace(old, new)
            assert edited != text, (variant, src, old)
            text = edited


def test_breakdown_variants_reach_the_loaders(monkeypatch):
    """The breakdown tool's cut variants are what the wrappers' loaders
    return inside ``swapped``, with the full library's argtypes, and the
    full library again after it."""
    from types import SimpleNamespace

    from repro_torch.kernels import tree_attention_bwd as tab
    tool = _tool("kernel_breakdown")

    def lib(*names):
        return SimpleNamespace(**{n: SimpleNamespace(argtypes=None,
                                                     restype=None)
                                  for n in names})

    fwd_names = ("tree_attention_fwd", "tree_attention_error_string")
    dq_names = ("tree_attention_bwd_dq", "tree_attention_bwd_dq_error_string")
    fwd, dq = lib(*fwd_names), lib(*dq_names)
    for base, names in ((fwd, fwd_names), (dq, dq_names)):
        for i, n in enumerate(names):
            getattr(base, n).argtypes = [ctypes.c_int] * (i + 1)
            getattr(base, n).restype = ctypes.c_int
    monkeypatch.setattr(build, "_LOADED", {ta.SOURCE: fwd,
                                           tab.SOURCES[0]: dq})
    dq_lib = lambda: tab._library(tab.SOURCES[0], dq_names[0], 1)  # noqa
    for mod, src, base, names, loader in (
            (ta, ta.SOURCE, fwd, fwd_names, ta._library),
            (tab, tab.SOURCES[0], dq, dq_names, dq_lib)):
        variant = lib(*names)
        with tool.swapped(build, mod, src, variant, base, names):
            assert loader() is variant
            for n in names:
                assert getattr(variant, n).argtypes == \
                    getattr(base, n).argtypes
                assert getattr(variant, n).restype is ctypes.c_int
        assert loader() is base
