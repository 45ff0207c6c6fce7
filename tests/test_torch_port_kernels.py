"""The port's native seam on the CPU: ``wesup_tpu_torch.native``'s build
and load, and ``ops/kernels.py``'s registry and launch.

- the build, driven by the host's g++ and by a stand-in nvcc put first on
  ``PATH`` (through ``kernels.recipe``, the CUDA library's own command):
  an unchanged tree reuses its library, an edited source or header gets a
  new name, a failing compile or link raises with the source's (or the
  library's) name and the compiler's log and leaves no file; nvcc
  compiles each source by its own process with the kernels' flags, then
  links once;
- the load builds a library once, even when threads ask for it at once,
  and gives its functions their signatures;
- the registry declares each kernel's C argument types as its
  ``extern "C"`` launch function in ``csrc/*.cu`` does, and every such
  function is registered;
- ``launch``, on a stand-in library and card: it loads the library,
  guards the card, appends the stream and calls, in that order; it counts
  one launch under the registry's name (``segment_sum_bwd``, not its C
  function's), and a nonzero code raises naming the kernel and counts
  nothing.
"""

import ast
import contextlib
import ctypes
import os
import re
import shlex
import shutil
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch import native  # noqa: E402
from wesup_tpu_torch.ops import kernels  # noqa: E402

# a stand-in nvcc: logs its command, refuses a source holding "#error",
# copies each source into its object, and refuses to link (leaving half a
# library behind) an object holding "LINK_FAIL"
FAKE_NVCC = """#!{python}
import sys
from pathlib import Path
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(repr(args) + "\\n")
out = Path(args[args.index("-o") + 1])
if "-c" in args:
    text = Path(args[-1]).read_text()
    if "#error" in text:
        print(args[-1] + ": error: stand-in failure")
        sys.exit(2)
    out.write_text(text)
else:
    objs = args[args.index("-o") + 2:]
    if any("LINK_FAIL" in Path(o).read_text() for o in objs):
        out.write_text("half a library")
        print("ld: stand-in link failure")
        sys.exit(1)
    out.write_text("library of " + " ".join(objs))
"""


@pytest.fixture(params=["g++", "nvcc"])
def tree(request, tmp_path, monkeypatch):
    """Two sources and a header, and the recipe that builds them: the
    host's g++, or the stand-in nvcc through ``kernels.recipe``."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "src"
    src.mkdir()
    if request.param == "g++":
        header = src / "seam.h"
        header.write_text("#define SEAM_VALUE 7\n")
        (src / "a.cpp").write_text(
            '#include "seam.h"\nextern "C" int seam_a() { return SEAM_VALUE; }\n')
        (src / "b.cpp").write_text('extern "C" int seam_b() { return 2; }\n')

        def recipe():
            return (["g++"], ["-O1", "-fPIC"],
                    [src / "a.cpp", src / "b.cpp"], [header])
        source = src / "a.cpp"
        # b.cpp defines it too
        link_fault = 'extern "C" int seam_b() { return 3; }\n'
        link_log = "multiple definition"
    else:
        header = src / "rows.cuh"
        header.write_text("// rows\n")
        (src / "a.cu").write_text('#include "rows.cuh"\n// a\n')
        (src / "b.cu").write_text("// b\n")
        log = tmp_path / "nvcc.log"
        log.touch()
        bin_dir = tmp_path / "bin"
        bin_dir.mkdir()
        nvcc = bin_dir / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
        nvcc.chmod(0o755)
        monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
        monkeypatch.setattr(kernels, "SOURCE_DIR", src)
        recipe = kernels.recipe
        source = src / "a.cu"
        link_fault, link_log = "// LINK_FAIL\n", "stand-in link failure"
    return SimpleNamespace(recipe=recipe, source=source, header=header,
                           build_dir=tmp_path / "build",
                           link_fault=link_fault, link_log=link_log)


@pytest.mark.parametrize("edit", [None, "source", "header"])
def test_build_reuses_an_unchanged_tree_and_renames_an_edited_one(tree,
                                                                  edit):
    first = native.build("seam", *tree.recipe())
    assert first.path.exists() and first.seconds > 0
    assert first.path.name.startswith("libseam_")
    assert "a." in first.log and "b." in first.log
    assert sorted(tree.build_dir.iterdir()) == [first.path]   # no objects
    if edit is not None:
        path = tree.source if edit == "source" else tree.header
        path.write_text(path.read_text() + "// edited\n")
    again = native.build("seam", *tree.recipe())
    if edit is None:
        assert again.path == first.path
        assert again.seconds == 0 and again.log == ""   # no compiler ran
    else:
        assert again.path != first.path and again.seconds > 0
        assert sorted(tree.build_dir.iterdir()) == sorted([first.path,
                                                           again.path])


@pytest.mark.parametrize("step", ["compile", "link"])
def test_failed_build_raises_and_leaves_no_file(tree, step):
    fault = ("#error stand-in failure\n" if step == "compile"
             else tree.link_fault)
    tree.source.write_text(tree.source.read_text() + fault)
    with pytest.raises(RuntimeError) as ex:
        native.build("seam", *tree.recipe())
    msg = str(ex.value)
    failed = tree.source.name if step == "compile" else "libseam_"
    assert msg.startswith(f"building {failed}") and " failed:\n" in msg
    assert ("stand-in failure" if step == "compile"   # the compiler's log
            else tree.link_log) in msg
    assert not list(tree.build_dir.iterdir())


@pytest.mark.parametrize("tree", ["nvcc"], indirect=True)
def test_nvcc_compiles_each_source_by_its_own_process_then_links(tree):
    compiler, flags, sources, headers = tree.recipe()
    assert compiler == [shutil.which("nvcc")]
    assert flags == list(kernels.NVCC_FLAGS)
    assert [p.name for p in sources] == ["a.cu", "b.cu"]
    assert [p.name for p in headers] == ["rows.cuh"]
    built = native.build("wesup_cuda", compiler, flags, sources, headers)
    calls = [ast.literal_eval(line) for line in
             (tree.source.parent.parent / "nvcc.log").read_text().splitlines()]
    # the compiles run at once, so they may log in either order
    compiles = sorted(calls[:2], key=lambda call: call[-1])
    objs = []
    for call, src in zip(compiles, sources):
        assert call[:len(flags)] == flags
        assert call[len(flags):] == ["-c", "-o", call[-2], str(src)]
        objs.append(call[-2])
    assert calls[2][:3] == ["-shared", "-o", calls[2][2]]
    assert calls[2][3:] == objs and len(calls) == 3
    assert built.path.read_text() == "library of " + " ".join(objs)
    assert f"== a.cu: {shlex.join([*compiler, *compiles[0]])}" in built.log


@pytest.mark.parametrize("tree", ["g++"], indirect=True)
def test_load_builds_once_and_sets_signatures(tree, monkeypatch):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "builds", {})
    calls = []
    build = native.build

    def counted(*args):
        calls.append(args)
        return build(*args)

    monkeypatch.setattr(native, "build", counted)
    signatures = {"seam_a": (ctypes.c_int, []), "seam_b": (ctypes.c_int, [])}
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(
        native.load("seam", signatures, tree.recipe))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(libs) == 4
    assert all(lib is libs[0] for lib in libs)
    assert native.load("seam", signatures, tree.recipe) is libs[0]
    assert libs[0].seam_a() == 7 and libs[0].seam_b() == 2
    assert libs[0].seam_a.restype is ctypes.c_int
    assert native.builds["seam"].path.exists()


# ---------------------------------------------------------------------------
# the registry and launch
# ---------------------------------------------------------------------------

_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong}


def _launch_functions() -> dict:
    """Each ``extern "C"`` function of ``csrc/*.cu``: its argument types."""
    found = {}
    for path in sorted(native.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       path.read_text()):
            types = []
            for param in params.split(","):
                words = param.replace("*", "* ").split()[:-1]
                ctype = " ".join(w for w in words if w != "const")
                types.append(_C_TYPES[ctype])
            found[name] = types
    return found


@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_registry_declares_each_kernel_as_its_source_does(name):
    kernel = kernels.KERNELS[name]
    assert kernel.counter == f"launches.{name}"
    assert [*kernel.argtypes, ctypes.c_void_p] == \
        _launch_functions()[kernel.symbol]


def test_every_launch_function_is_registered():
    symbols = {k.symbol for k in kernels.KERNELS.values()}
    assert symbols == set(_launch_functions())
    assert kernels.KERNELS["segment_sum_bwd"].symbol == "wesup_cell_pool0_bwd"


class FakeLibrary:
    """A kernel library whose every function records its call and returns
    ``code``."""

    def __init__(self, code, events):
        self.code, self.events, self.calls = code, events, []

    def __getattr__(self, symbol):
        def fn(*args):
            self.events.append("call")
            self.calls.append((symbol, args))
            return self.code
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """A stand-in card: ``library()``, the device guard and the current
    stream record what they were asked, in order."""
    events, guarded = [], []

    def install(code):
        lib = FakeLibrary(code, events)

        def library():
            events.append("load")
            return lib

        @contextlib.contextmanager
        def device(dev):
            events.append("guard")
            guarded.append(dev)
            yield

        def current_stream(dev):
            events.append("stream")
            guarded.append(dev)
            return SimpleNamespace(cuda_stream=0x5EA4)

        monkeypatch.setattr(kernels, "library", library)
        monkeypatch.setattr(torch.cuda, "device", device)
        monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
        return lib

    kernels.reset_launches()
    yield SimpleNamespace(install=install, events=events, guarded=guarded)
    kernels.reset_launches()


@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_launch_appends_the_stream_and_counts_the_registry_name(fake_card,
                                                                name):
    lib = fake_card.install(0)
    dev = torch.device("cuda", 1)
    kernels.launch(name, dev, 11, 22, 33)
    assert fake_card.events == ["load", "guard", "stream", "call"]
    assert fake_card.guarded == [dev, dev]
    assert lib.calls == [(kernels.KERNELS[name].symbol, (11, 22, 33, 0x5EA4))]
    counts = kernels.launch_counts()
    assert counts == {n: int(n == name) for n in kernels.KERNELS}


def test_failed_launch_raises_naming_the_kernel_and_counts_nothing(
        fake_card):
    lib = fake_card.install(719)
    with pytest.raises(RuntimeError,
                       match="^segment_sum_bwd: CUDA launch failed with "
                             "error 719$"):
        kernels.launch("segment_sum_bwd", torch.device("cuda", 0), 1)
    assert lib.calls == [("wesup_cell_pool0_bwd", (1, 0x5EA4))]
    assert not any(kernels.launch_counts().values())
