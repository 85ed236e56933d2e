"""The port's storage modules (greengage_tpu_torch/storage/: corruption,
native, blockfile, dictionary, manifest, the block-file TableStore)
against the JAX package's.

  * tests/test_storage.py (13 tests) and the cases of
    tests/test_corruption_fuzz.py that are not marked slow, replayed on
    the port: each JAX test function runs with its module's storage names
    bound to the port's modules (and the JAX storage modules it imports in
    its body redirected to the port's for the call), on both codec routes
    where the JAX test runs both;
  * the frames ``native.block_encode`` writes are byte-identical between
    the two packages on both routes, and so are the hashes;
  * the codec is built from native/ggcodec.cpp into
    greengage_tpu_torch/_build/ and never writes into native/; where the
    build fails, the numpy route runs and reports itself.
"""

import os
import sys
import types

import numpy as np
import pytest

from greengage_tpu.storage import native as jnative
from greengage_tpu_torch import catalog as TC
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.storage import blockfile as tblockfile
from greengage_tpu_torch.storage import corruption as tcorruption
from greengage_tpu_torch.storage import dictionary as tdictionary
from greengage_tpu_torch.storage import manifest as tmanifest
from greengage_tpu_torch.storage import native as tnative
from greengage_tpu_torch.storage import table_store as ttable_store

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_corruption_fuzz as J_FUZZ  # noqa: E402
import test_storage as J_STORAGE  # noqa: E402

# the JAX module names a replayed test body may import -> the port's
REDIRECT = {
    "greengage_tpu.storage.native": tnative,
    "greengage_tpu.storage.blockfile": tblockfile,
    "greengage_tpu.storage.corruption": tcorruption,
    "greengage_tpu.storage.dictionary": tdictionary,
    "greengage_tpu.storage.manifest": tmanifest,
    "greengage_tpu.storage.table_store": ttable_store,
}
# the module-level names of each JAX test file -> the port's objects
PORT_NAMES = {
    "native": tnative, "T": TT, "Catalog": TC.Catalog, "Column": TC.Column,
    "DistPolicy": TC.DistPolicy, "PolicyKind": TC.PolicyKind,
    "TableSchema": TC.TableSchema,
    "read_column_file": tblockfile.read_column_file,
    "write_column_file": tblockfile.write_column_file,
    "FOOTER_TAIL": tblockfile.FOOTER_TAIL,
    "CorruptionError": tcorruption.CorruptionError,
    "Dictionary": tdictionary.Dictionary, "Manifest": tmanifest.Manifest,
    "TableStore": ttable_store.TableStore,
}


def _cases(module):
    """(test name, parameters) of every test of ``module`` not marked
    slow, one per parametrize combination (and per codec route where the
    test takes the ``codec`` fixture)."""
    out = []
    for name, fn in vars(module).items():
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = getattr(fn, "pytestmark", [])
        if any(m.name == "slow" for m in marks):
            continue
        combos = [{}]
        for m in marks:
            if m.name != "parametrize":
                continue
            names = [a.strip() for a in m.args[0].split(",")] \
                if isinstance(m.args[0], str) else list(m.args[0])
            combos = [dict(c, **dict(zip(names, v if len(names) > 1
                                         else (v,))))
                      for c in combos for v in m.args[1]]
        if "codec" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
            combos = [dict(c, codec=r) for c in combos
                      for r in ("native", "numpy")]
        for c in combos:
            ident = "-".join(str(v) for v in c.values())
            out.append(pytest.param(name, c,
                                    id=f"{name}[{ident}]" if c else name))
    return out


def _replay(module, name, params, request, monkeypatch):
    fn = getattr(module, name)
    g = dict(fn.__globals__)
    g.update({k: v for k, v in PORT_NAMES.items() if k in g})
    # the file's helpers (_mk_store, _frame, _file, ...) see the port too
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) \
                and v.__module__ == module.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    port_fn = g[name]
    code = fn.__code__
    kwargs = {}
    for arg in code.co_varnames[:code.co_argcount]:
        if arg in params and arg != "codec":
            kwargs[arg] = params[arg]
        elif arg == "codec":
            if params["codec"] == "numpy":
                monkeypatch.setattr(tnative, "_lib", False)
            else:
                assert tnative.route() == "native", tnative.build_log()
            kwargs[arg] = params["codec"]
        elif arg == "monkeypatch":
            kwargs[arg] = monkeypatch
        else:
            kwargs[arg] = request.getfixturevalue(arg)
    saved = {k: sys.modules.get(k) for k in REDIRECT}
    sys.modules.update(REDIRECT)
    try:
        port_fn(**kwargs)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@pytest.mark.parametrize("name,params", _cases(J_STORAGE))
def test_storage_replayed_on_the_port(name, params, request, monkeypatch):
    _replay(J_STORAGE, name, params, request, monkeypatch)


@pytest.mark.parametrize("name,params", _cases(J_FUZZ))
def test_corruption_fuzz_replayed_on_the_port(name, params, request,
                                              monkeypatch):
    _replay(J_FUZZ, name, params, request, monkeypatch)


def test_the_replay_covers_both_files():
    assert len({p.values[0] for p in _cases(J_STORAGE)}) == 13
    assert len({p.values[0] for p in _cases(J_FUZZ)}) == 9


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("comp", [tnative.COMP_NONE, tnative.COMP_ZLIB])
def test_frames_are_byte_identical_to_the_jax_packages(route, comp,
                                                       monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(tnative, "_lib", False)
        monkeypatch.setattr(jnative, "_lib", False)
    rng = np.random.default_rng(11)
    for raw in (rng.integers(0, 7, 5000).astype(np.int64).tobytes(),
                rng.standard_normal(3000).tobytes(), b"", b"x" * 17):
        frame = tnative.block_encode(raw, len(raw) // 8, comp)
        assert frame == jnative.block_encode(raw, len(raw) // 8, comp)
        assert jnative.block_decode(frame)[0] == raw
        assert tnative.block_decode(frame)[0] == raw


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_hashes_equal_the_jax_packages(route, monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(tnative, "_lib", False)
    vals = np.random.default_rng(5).integers(-2**62, 2**62, 10_000)
    h = tnative.hash_i64(vals)
    assert np.array_equal(h, jnative.hash_i64(vals))
    assert np.array_equal(tnative.hash_i64(vals, seed=7),
                          jnative.hash_i64(vals, seed=7))
    assert np.array_equal(tnative.hash_combine(h, h[::-1].copy()),
                          jnative.hash_combine(h, h[::-1].copy()))
    for s in (b"", b"a", b"0123456789abcdef", "ünïcode".encode(), b"x" * 33):
        assert tnative.hash_bytes(s) == jnative.hash_bytes(s)
        assert tnative.hash_bytes(s, 3) == jnative.hash_bytes(s, 3)
    # the storage layer's one definition: the dictionaries' LUTs and the
    # device side's text LUTs hash through it
    from greengage_tpu_torch.ops import hashing as ohashing
    from greengage_tpu_torch.storage.dictionary import Dictionary
    words = ["", "a", "Customer#000000001", "ünïcode"]
    assert list(Dictionary(words).hashes()[:-1]) == [
        tnative.hash_bytes(w.encode()) for w in words]
    assert ohashing.text_hash_lut(words).tolist()[:-1] == [
        tnative.hash_bytes(w.encode()) for w in words]


def test_the_codec_builds_into_build_and_never_into_native(tmp_path,
                                                           monkeypatch):
    """The port compiles native/ggcodec.cpp with g++ straight into its
    build directory: the compiler's only output is there, it runs in no
    directory of native/, and nothing of the port's lands in native/ (the
    JAX package's own ``make`` may build native/libggcodec.so meanwhile,
    in other processes: that file is the JAX package's)."""
    native_dir = os.path.dirname(tnative.SOURCE)
    sources = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
               for f in ("ggcodec.cpp", "Makefile")}
    calls = []
    real_run = tnative.subprocess.run

    def spy(cmd, **kw):
        calls.append((list(cmd), kw))
        return real_run(cmd, **kw)

    monkeypatch.setattr(tnative.subprocess, "run", spy)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.route() == "native", tnative.build_log()
    (cmd, kw), = calls
    out = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path / "_build")
    assert tnative.SOURCE in cmd and "cwd" not in kw
    assert "make" not in os.path.basename(cmd[0])
    built = os.listdir(tmp_path / "_build")
    assert built == [os.path.basename(tnative.library_path())]
    assert built[0].startswith("libggcodec-") and built[0].endswith(".so")
    assert not [f for f in os.listdir(native_dir)
                if f.startswith("libggcodec-") or f.endswith(".tmp")]
    assert {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
            for f in sources} == sources
    monkeypatch.undo()
    # the package's own build directory is where it goes by default
    assert os.path.dirname(tnative.library_path()) == os.path.join(
        os.path.dirname(os.path.dirname(tnative.__file__)), "_build")


def test_a_failed_build_runs_the_numpy_route(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert tnative.route() == "numpy"
    assert "no-such-compiler" in tnative.build_log()
    frame = tnative.block_encode(b"abc" * 100, 100)
    monkeypatch.setattr(jnative, "_lib", False)
    assert frame == jnative.block_encode(b"abc" * 100, 100)
