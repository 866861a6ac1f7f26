"""The port's analyzer (``tpuparquet_torch/analyze``) against the
reference's (``tools/analyze``).

Each pass runs over a small seeded-bug tree and its clean twin, written
once under ``tpuparquet/`` for the reference and once under
``tpuparquet_torch/`` for the port: the two analyzers' findings must be
equal with the package name swapped.  The port's gate over the real tree
passes with 0 findings and 0 stale allowlist entries, and ``parquet_tool
analyze`` gives the reference's output shape and exit codes.
"""

import io
import json
import os
import sys
import textwrap
from contextlib import redirect_stdout

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import tools.analyze as ref_analyze  # noqa: E402
import tpuparquet_torch.analyze as port_analyze  # noqa: E402
from tpuparquet.cli import parquet_tool as jax_pt  # noqa: E402
from tpuparquet_torch.analyze import counters, envknobs, threads  # noqa: E402
from tpuparquet_torch.analyze.__main__ import main as analyze_main  # noqa: E402
from tpuparquet_torch.cli import parquet_tool as pt  # noqa: E402

_REF_PKG = "tpuparquet/"
_PORT_PKG = "tpuparquet_torch/"


def _swap(text: str) -> str:
    return text.replace(_REF_PKG, _PORT_PKG)


def _trees(files, readme=None):
    """The reference's and the port's RepoTree of one fixture."""
    files = {k: textwrap.dedent(v) for k, v in files.items()}
    ref = ref_analyze.RepoTree(files, readme=readme)
    port = port_analyze.RepoTree({_swap(k): v for k, v in files.items()},
                                 readme=readme)
    return ref, port


def _norm(findings, swap):
    """Findings as sorted dicts; the env-knob pass names its roots,
    which differ by design (the reference's tools and bench script, the
    port's card script)."""
    roots = str((ref_analyze if swap else port_analyze).envknobs.ROOTS)
    out = []
    for f in findings:
        d = f.as_dict()
        d["why"] = d["why"].replace(roots, "<roots>")
        if swap:
            d = {k: _swap(v) if isinstance(v, str) else v
                 for k, v in d.items()}
        out.append(d)
    return sorted(out, key=lambda d: (d["file"], d["line"], d["code"],
                                      d["key"]))


# ----------------------------------------------------------------------
# fixtures, one seeded bug and its clean twin a pass (after the
# reference's tests/test_analyze.py)
# ----------------------------------------------------------------------

_STATS = """
    import dataclasses

    @dataclasses.dataclass
    class DecodeStats:
        pages: int = 0
        values: int = 0
        io_retries: int = 0
        wall_s: float = 0.0
        hists: dict = dataclasses.field(default_factory=dict)
        events: object = None

        _MERGE_FIELDS = ("pages", "values", "io_retries")

    _FAULT_OBSERVABILITY_FIELDS = ("io_retries",)
"""

_BUMPS = """
    from .stats import current_stats

    def decode_page():
        st = current_stats()
        if st is not None:
            st.pages += 1
            st.values += 128

    def retry(counter="io_retries"):
        pass
"""

_FAULTS = '''
    """Sites table:

    ``io.fake.read``                      reader — ``oserror``
    """

    SITES: dict = {
        "io.fake.read": ("oserror", "corrupt"),
    }
'''

_HOOKED = """
    from ..faults import fault_point

    def read():
        fault_point("io.fake.read")
"""

_README = ("## Env knobs\n\n| `TPQ_ALPHA` | x | y |\n"
           "| `TPQ_BETA` | x | y |\n\n## Next\n")

_ENV = """
    import os

    def _env_int(name, default):
        try:
            return int(os.environ.get(name, ""))
        except ValueError:
            return default

    def alpha():
        return os.environ.get("TPQ_ALPHA", "1")

    def beta():
        return _env_int("TPQ_BETA", 3)
"""

_ERRORS = """
    class ScanError(Exception):
        def __init__(self, message="", *, file=None, row_group=None,
                     column=None, page=None):
            super().__init__(message)

    class CorruptPageError(ScanError):
        pass
"""

CASES = {
    "counters-unmerged": ("counters", {
        "tpuparquet/stats.py": _STATS.replace(
            '("pages", "values", "io_retries")', '("pages", "io_retries")'),
        "tpuparquet/io.py": _BUMPS}, None),
    "counters-dead": ("counters", {
        "tpuparquet/stats.py": _STATS,
        "tpuparquet/io.py": _BUMPS.replace("st.values += 128", "pass")},
        None),
    "counters-clean": ("counters", {
        "tpuparquet/stats.py": _STATS, "tpuparquet/io.py": _BUMPS}, None),
    "fault-sites-drift": ("fault-sites", {
        "tpuparquet/faults.py": _FAULTS,
        "tpuparquet/io/reader.py": _HOOKED.replace("io.fake.read",
                                                   "io.fake.raed"),
        "tests/test_torch_x.py": """
            def test_y(inj):
                inj.inject("io.fake.gone", "oserror")
                inj.inject("io.fake.read", "hang")
        """}, None),
    "fault-sites-clean": ("fault-sites", {
        "tpuparquet/faults.py": _FAULTS,
        "tpuparquet/io/reader.py": _HOOKED,
        "tests/test_torch_x.py": """
            def test_y(inj):
                inj.inject("io.fake.read", "oserror")
        """}, None),
    "env-knobs-drift": ("env-knobs", {
        "tpuparquet/mod.py": _ENV.replace('"TPQ_ALPHA"', '"TPQ_GAMMA"')},
        _README),
    "env-knobs-clean": ("env-knobs", {"tpuparquet/mod.py": _ENV}, _README),
    "atomic-write-bare": ("atomic-write", {"tpuparquet/obs/x.py": """
        def publish(path, body):
            with open(path, "w") as f:
                f.write(body)
    """}, None),
    "atomic-write-clean": ("atomic-write", {"tpuparquet/obs/x.py": """
        import os

        def publish(path, body):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(body)
            os.replace(tmp, path)
    """}, None),
    "recorder-guard-unguarded": ("recorder-guard", {"tpuparquet/io/x.py": """
        from .obs import recorder as _flightrec

        def decode(pages):
            for p in pages:
                _flightrec.flight("page", page=p)

        def fetch(uri):
            _flightrec.flight("emu_fault", file=uri)
    """}, None),
    "recorder-guard-clean": ("recorder-guard", {"tpuparquet/io/x.py": """
        from .obs import recorder as _flightrec

        def decode(pages):
            for p in pages:
                if _flightrec._active is not None:
                    _flightrec.flight("page", page=p)
    """}, None),
    "thread-safety-unlocked": ("thread-safety", {"tpuparquet/reg.py": """
        import threading

        _registry = {}
        _active = None
        _lock = threading.Lock()

        def register(k, v):
            _registry[k] = v

        def install(x):
            global _active
            _active = x
    """}, None),
    "thread-safety-cycle": ("thread-safety", {"tpuparquet/a.py": """
        import threading

        _la = threading.Lock()

        def inner():
            with _la:
                pass

        def outer():
            with _la:
                inner()
    """}, None),
    "thread-safety-clean": ("thread-safety", {"tpuparquet/a.py": """
        import threading

        _la = threading.Lock()
        _lb = threading.Lock()
        _registry = {}

        def f(k):
            with _la:
                with _lb:
                    _registry[k] = 1
    """}, None),
    "resource-lifecycle-leak": ("resource-lifecycle", {"tpuparquet/io/x.py": """
        def head(path, n):
            f = open(path, "rb")
            data = decode(f.read(n))
            f.close()
            return data

        class Source:
            def __init__(self, path):
                self._f = open(path, "rb")
                self._size = probe_size(path)
    """}, None),
    "resource-lifecycle-clean": ("resource-lifecycle", {"tpuparquet/io/x.py": """
        def peek(path):
            f = open(path, "rb")
            try:
                return f.read(4)
            finally:
                f.close()
    """}, None),
    "exception-taxonomy-plain": ("exception-taxonomy", {
        "tpuparquet/errors.py": _ERRORS, "tpuparquet/io/x.py": """
        from ..errors import CorruptPageError

        def decode(path):
            raise RuntimeError("bad crc in " + path)

        def page(path):
            raise CorruptPageError("bad crc")
    """}, None),
    "exception-taxonomy-clean": ("exception-taxonomy", {
        "tpuparquet/errors.py": _ERRORS, "tpuparquet/io/x.py": """
        from ..errors import CorruptPageError

        def decode(path, pg):
            raise CorruptPageError("bad crc", file=path, page=pg)
    """}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_findings_equal_reference(case):
    name, files, readme = CASES[case]
    ref_tree, port_tree = _trees(files, readme)
    ref = _norm(ref_analyze.PASSES[name](ref_tree), swap=True)
    port = _norm(port_analyze.PASSES[name](port_tree), swap=False)
    assert port == ref
    # the seeded bugs are found and the clean twins pass: the equality
    # is not that of two empty lists
    assert bool(port) == (not case.endswith("-clean"))


def test_passes_are_the_reference_passes():
    assert list(port_analyze.PASSES) == list(ref_analyze.PASSES)


# ----------------------------------------------------------------------
# where the port's copy reads its own tree
# ----------------------------------------------------------------------

_STATS_DERIVED = """
    import dataclasses
    from dataclasses import fields

    @dataclasses.dataclass
    class DecodeStats:
        pages: int = 0
        values: int = 0
        io_retries: int = 0
        wall_s: float = 0.0
        hists: dict = dataclasses.field(default_factory=dict)
        events: object = None

    _MERGE_FIELDS = tuple(f.name for f in fields(DecodeStats)
                          if f.name not in ("wall_s", "hists", "events"))

    _FAULT_OBSERVABILITY_FIELDS = ("io_retries",)
"""


@pytest.mark.parametrize("stats,code", [
    (_STATS_DERIVED, None),
    (_STATS_DERIVED.replace('("wall_s", "hists", "events")',
                            '("wall_s", "hists", "events", "values")'),
     "unmerged-counter"),
    (_STATS_DERIVED.replace("fields(DecodeStats)", "fields(Other)"),
     "registry-unreadable"),
], ids=["derived", "derived-drops-counter", "unrecognised"])
def test_counters_read_derived_merge_fields(stats, code):
    """The port derives ``_MERGE_FIELDS`` from the dataclass fields; the
    pass evaluates that form and still catches a dropped counter."""
    tree = port_analyze.RepoTree({
        "tpuparquet_torch/stats.py": textwrap.dedent(stats),
        "tpuparquet_torch/io.py": textwrap.dedent(_BUMPS)})
    assert [f.code for f in counters.run(tree)] == ([code] if code else [])


def test_counters_real_registry_is_read():
    tree = port_analyze.RepoTree.from_disk(_REPO)
    reg = counters.read_registry(tree)
    assert reg is not None and "pages" in reg["merge"]
    assert "wall_s" not in reg["merge"]
    assert set(reg["fault"]) <= set(reg["merge"])


def test_env_catalog_stops_at_tool_only_knobs():
    readme = _README.replace("\n\n## Next", "\n\nTool-only knobs: "
                             "`TPQ_BENCH_X` (`bench.py`).\n\n## Next")
    tree = port_analyze.RepoTree({"tpuparquet_torch/mod.py":
                                  textwrap.dedent(_ENV)}, readme=readme)
    assert envknobs.readme_knobs(tree) == {"TPQ_ALPHA", "TPQ_BETA"}
    assert envknobs.run(tree) == []


def test_lock_resolves_through_module_function_return_type():
    tree = port_analyze.RepoTree({"tpuparquet_torch/k.py": textwrap.dedent("""
        import threading

        class _State:
            def __init__(self):
                self.lock = threading.Lock()

        def _state() -> _State:
            return _State()

        def launch():
            st = _state()
            with st.lock:
                pass
    """)})
    assert threads.run(tree) == []
    graph = threads.static_graph(tree)
    assert graph["unresolved"] == [] and len(graph["sites"]) == 1


def test_annotated_module_global_is_typed():
    """``rec = _active`` takes the type of ``_active: FlightRecorder |
    None``, so a flight record's slot lock is reachable: a lock held
    around it gets its edge."""
    tree = port_analyze.RepoTree({
        "tpuparquet_torch/rec.py": textwrap.dedent("""
            import threading

            class Slots:
                def __init__(self):
                    self._lock = threading.Lock()

                def get(self):
                    with self._lock:
                        return 1

            class Recorder:
                def __init__(self):
                    self._slots = Slots()

                def record(self, kind):
                    self._slots.get()

            _active: Recorder | None = None

            def flight(kind):
                rec = _active
                if rec is not None:
                    rec.record(kind)
        """),
        "tpuparquet_torch/src.py": textwrap.dedent("""
            import threading
            from . import rec as _flightrec

            _held = threading.Lock()

            def read():
                with _held:
                    _flightrec.flight("emu_fault")
        """)})
    graph = threads.static_graph(tree)
    assert graph["edges"] == [["tpuparquet_torch/src.py:5",
                               "tpuparquet_torch/rec.py:6"]]


def test_exit_handler_registration_is_not_a_call():
    tree = port_analyze.RepoTree({"tpuparquet_torch/x.py": textwrap.dedent("""
        import atexit
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def _flush():
            with _b:
                pass

        def start():
            with _a:
                atexit.register(_flush)
    """)})
    assert threads.static_graph(tree)["edges"] == []
    assert threads.run(tree) == []


@pytest.mark.parametrize("doc,ok", [
    ({"locks": [], "edges": [["tpuparquet_torch/a.py:4",
                              "tpuparquet_torch/a.py:5", 1]],
      "violations": []}, True),
    ({"locks": [], "edges": [["tpuparquet_torch/a.py:5",
                              "tpuparquet_torch/a.py:4", 1]],
      "violations": []}, False),
    ({"locks": [], "edges": [],
      "violations": [{"kind": "lock-cycle", "cycle": ["x", "x"]}]}, False),
    ({"locks": [], "edges": [["/usr/lib/x.py:1", "tpuparquet_torch/a.py:4",
                              1]], "violations": []}, True),
], ids=["subgraph", "missing-edge", "violation", "foreign"])
def test_verify_runtime_graph(doc, ok):
    tree = port_analyze.RepoTree({"tpuparquet_torch/a.py": textwrap.dedent("""
        import threading

        _la = threading.Lock()
        _lb = threading.Lock()

        def f():
            with _la:
                with _lb:
                    pass
    """)})
    assert (threads.verify_runtime_graph(tree, doc) == []) == ok


# ----------------------------------------------------------------------
# the real tree
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate():
    return port_analyze.run_analysis(root=_REPO)


def test_gate_passes_over_the_port(gate):
    assert gate["findings"] == [], "\n".join(
        f"{f['file']}:{f['line']} {f['pass']}/{f['code']} {f['key']}"
        for f in gate["findings"])
    assert gate["stale_allowlist"] == []
    assert gate["ok"]
    assert sorted(gate["counts"]) == sorted(port_analyze.PASSES)
    assert all(f["file"] == "README.md" or f["file"].startswith(_PORT_PKG)
               for f in gate["suppressed"])


def test_allowlist_entries_have_reasons_and_targets():
    entries = json.load(open(port_analyze.DEFAULT_ALLOWLIST))["entries"]
    assert entries and all(e["reason"].strip() for e in entries)
    report = port_analyze.Allowlist(entries).audit(
        port_analyze.RepoTree.from_disk(_REPO))
    assert report["ok"], report["missing_target"]


def test_static_lock_graph_resolves_every_lock():
    graph = threads.static_graph(port_analyze.RepoTree.from_disk(_REPO))
    assert graph["unresolved"] == []
    assert all(s.startswith(_PORT_PKG) for s in graph["sites"])


def test_analyzer_imports_neither_package_nor_tools():
    base = os.path.join(_REPO, "tpuparquet_torch", "analyze")
    for fn in os.listdir(base):
        if fn.endswith(".py"):
            src = open(os.path.join(base, fn)).read()
            for bad in ("import jax", "from jax", "import tools",
                        "from tools", "import tpuparquet\n",
                        "from tpuparquet ", "from tpuparquet.",
                        "import tpuparquet."):
                assert bad not in src, (fn, bad)


def test_chip_smoke_emulator_knobs_match_settings():
    import chip_smoke

    assert chip_smoke.PHASE14_EMU_KNOBS == {
        "TPQ_EMU_" + k.upper(): str(v)
        for k, v in chip_smoke.PHASE14_EMU.items()}


# ----------------------------------------------------------------------
# the command lines
# ----------------------------------------------------------------------

def _run(mod, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


def _seeded_root(tmp_path, pkg):
    """A checkout with one non-atomic write under ``pkg``."""
    root = tmp_path / pkg.rstrip("/")
    (root / pkg / "obs").mkdir(parents=True)
    (root / pkg / "obs" / "x.py").write_text(textwrap.dedent("""
        def publish(path, body):
            with open(path, "w") as f:
                f.write(body)
    """))
    (root / "tools" / "analyze").mkdir(parents=True)
    return root


def test_cli_analyze_on_seeded_trees(tmp_path):
    got = {}
    for name, mod, pkg in (("ref", jax_pt, _REF_PKG),
                           ("port", pt, _PORT_PKG)):
        root = _seeded_root(tmp_path, pkg)
        argv = ["analyze", "--root", str(root), "--pass", "atomic-write"]
        rc, text = _run(mod, argv)
        assert rc == 1 and "gate FAILED" in text
        rc, text = _run(mod, argv + ["--json"])
        assert rc == 1
        got[name] = json.loads(text)
    assert set(got["port"]) == set(got["ref"])
    assert [_swap(json.dumps(f, sort_keys=True))
            for f in got["ref"]["findings"]] == \
        [json.dumps(f, sort_keys=True) for f in got["port"]["findings"]]


def test_cli_analyze_real_tree_passes():
    argv = ["analyze", "--pass", "counters", "--pass", "atomic-write"]
    rc, text = _run(pt, argv)
    assert rc == 0, text
    assert text.strip().splitlines()[-1].endswith("gate PASSED")
    rc, text = _run(pt, argv + ["--json"])
    doc = json.loads(text)
    assert rc == 0 and doc["ok"] and doc["root"] == _REPO
    assert set(doc) == {"findings", "suppressed", "stale_allowlist",
                        "counts", "timings_s", "ok", "root"}


def test_cli_allowlist_audit_shape():
    docs = {}
    for name, mod in (("ref", jax_pt), ("port", pt)):
        rc, text = _run(mod, ["analyze", "--allowlist-audit", "--json"])
        assert rc == 0, text
        docs[name] = json.loads(text)
    assert set(docs["port"]) == set(docs["ref"])
    assert set(docs["port"]["entries"][0]) == set(docs["ref"]["entries"][0])
    rc, text = _run(pt, ["analyze", "--allowlist-audit"])
    assert rc == 0 and text.strip().endswith("PASSED")


def test_module_cli_lock_graph_and_audit(capsys):
    assert analyze_main(["--lock-graph"]) == 0
    assert "0 unresolved" in capsys.readouterr().out
    assert analyze_main(["--allowlist-audit"]) == 0
    assert capsys.readouterr().out.strip().endswith("PASSED")
