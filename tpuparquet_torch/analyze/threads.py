"""Thread-safety pass v2: whole-program lock order + guarded state.

The serve-regime roadmap (long-lived multi-tenant process) makes
"module global mutated off-thread" the highest-risk latent bug class:
it works in every test and loses state under production concurrency.
This pass inventories **module-level mutable state** in every module
of the package that imports ``threading`` and requires each piece
to be one of:

* ``threading.local()`` — per-thread by construction;
* a lock/condition itself;
* an instance of a *self-synchronized* class (its ``__init__`` binds
  a ``threading.Lock``/``RLock``, or delegates to another
  self-synchronized class such as ``ThreadSlots``);
* mutated **only under a module-level lock** (every rebind of a
  ``global``, and every container mutation, lexically inside
  ``with <lock>:``);
* or explicitly allowlisted with a reason (the atomic
  reference-swap globals like ``faults._active`` are the intended
  tenants).

v2 extends the round-13 lock-graph half from "threaded modules only,
module-level + ``self.`` locks" to a **whole-program analysis** over
all of the package:

* Lock identity is the **creation site** ``path:lineno`` of the
  ``threading.Lock()``/``RLock()``/``Condition()`` constructor call —
  the same key the runtime recorder (the package's ``lockcheck.py``)
  observes, so the static graph and the recorded graph are directly
  comparable (``python -m tpuparquet_torch.analyze --verify-lockcheck``).
* The function universe includes **nested functions** (thread-pool
  task closures), and call resolution follows **function-valued
  arguments** — ``ex.submit(_task, ...)``, ``threading.Thread(
  target=fn)``, ``retry_transient(_one)`` — so "caller holds L,
  worker acquires M" becomes a visible L→M edge across the pool
  submission boundary.
* ``with`` lock expressions resolve through lightweight type
  inference: own-class attributes, annotated parameters and return
  types, ``v = Ctor(...)`` locals, module-level singletons, and
  one level of attribute aliasing (``self._io_lock = nh.lock``).
  A *lockish-named* ``with`` expression that still fails to resolve
  is its own finding (``unresolved-lock-with``) — the graph refuses
  to silently drop what it cannot model.
* Cycles (including self-loops — two instances from one creation
  site, or a genuine reentrant acquire) are findings; ``RLock`` and
  ``Condition`` sites are exempt from the SELF-loop rule only, since
  same-thread reacquisition is their contract.

Call resolution stays conservative: ambiguous attribute calls fan
out to every analyzed definer — a false edge can only *add*
scrutiny, never hide a cycle.
"""

from __future__ import annotations

import ast

from .astutil import PKG, Finding, RepoTree, call_name

PASS = "thread-safety"

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")
#: reentrant by contract: a self-loop (same creation site reacquired
#: while held) is the normal operating mode, not a deadlock
_REENTRANT_KINDS = frozenset({"RLock", "Condition"})
_CONTAINER_CTORS = ("dict", "list", "set", "deque", "OrderedDict",
                    "defaultdict", "WeakSet", "WeakValueDictionary",
                    "WeakKeyDictionary", "Counter")
_MUTATORS = ("append", "add", "update", "extend", "insert", "remove",
             "discard", "clear", "pop", "popitem", "setdefault",
             "appendleft", "extendleft")
#: method names too generic to resolve call edges through
_GENERIC_METHODS = frozenset({
    "get", "pop", "update", "add", "append", "items", "keys",
    "values", "copy", "clear", "extend", "remove", "discard",
    "setdefault", "popitem", "join", "start", "put", "read", "write",
    "close", "acquire", "release", "wait", "notify", "notify_all",
    "sort", "insert", "index", "count", "encode", "decode", "format",
    "split", "strip", "startswith", "endswith", "record", "result",
    "submit", "map", "shutdown", "done", "cancel", "set",
})
#: with-expression names that LOOK like locks; failing to resolve one
#: of these is a finding, failing to resolve `with open(...)` is not
_LOCKISH = ("lock", "mutex", "_cv", "cv", "cond")


def _imports_threading(mod: ast.AST) -> bool:
    for node in ast.walk(mod):
        if isinstance(node, ast.Import):
            if any(a.name == "threading" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == "threading":
                return True
    return False


def _ctor_name(value) -> str | None:
    """The constructor name of a call expression, if any."""
    if isinstance(value, ast.Call):
        return call_name(value)
    return None


class _Module:
    """Per-module facts the mutable-state half reasons over."""

    def __init__(self, path: str, mod: ast.AST):
        self.path = path
        self.mod = mod
        self.locks: set[str] = set()       # module-level lock names
        self.locals_: set[str] = set()     # threading.local names
        self.containers: dict[str, int] = {}   # name -> def line
        self.instances: dict[str, tuple] = {}  # name -> (ctor, line)
        #: module-level ``name: Type = ...`` -> the annotation's type
        #: (``_active: FlightRecorder | None = None``), which a
        #: ``rec = _active`` local takes
        self.annotated: dict[str, str] = {}
        self.scalars: dict[str, int] = {}  # every other module name
        self.globals_: set[str] = set()    # names rebound via global
        self.classes: dict[str, ast.ClassDef] = {}
        self.functions: dict[str, ast.AST] = {}
        self.imports: dict[str, str] = {}  # local alias -> source name
        #: plain ``import X`` aliases — attribute calls through these
        #: are stdlib/external and must not fan out by method name
        self.module_imports: set[str] = set()
        #: ``_RealLock = threading.Lock`` style ctor aliases -> kind
        self.lock_ctor_aliases: dict[str, str] = {}
        self._scan()

    def _lock_kind(self, ctor: str | None) -> str | None:
        if ctor in _LOCK_CTORS:
            return ctor
        return self.lock_ctor_aliases.get(ctor or "")

    def _scan(self) -> None:
        for node in self.mod.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                targets = [node.target]
                value = node.value
                ann = _ann_name(node.annotation)
                if ann:
                    self.annotated[node.target.id] = ann
            else:
                continue
            # constructor aliasing: `_RealLock = threading.Lock`
            # (the lockcheck idiom for keeping a pre-patch original)
            alias_kind = None
            if isinstance(value, ast.Attribute) and \
                    value.attr in _LOCK_CTORS:
                alias_kind = value.attr
            elif isinstance(value, ast.Name) and \
                    value.id in _LOCK_CTORS:
                alias_kind = value.id
            if alias_kind is not None:
                for t in targets:
                    self.lock_ctor_aliases[t.id] = alias_kind
                continue
            ctor = _ctor_name(value)
            for t in targets:
                if t.id == "__all__":
                    continue
                if self._lock_kind(ctor):
                    self.locks.add(t.id)
                elif ctor == "local":
                    self.locals_.add(t.id)
                elif ctor in _CONTAINER_CTORS or \
                        isinstance(value, (ast.Dict, ast.List,
                                           ast.Set)):
                    self.containers[t.id] = node.lineno
                elif ctor is not None and ctor[:1].isupper():
                    self.instances[t.id] = (ctor, node.lineno)
                else:
                    self.scalars[t.id] = node.lineno
        for node in ast.walk(self.mod):
            if isinstance(node, ast.Global):
                self.globals_.update(node.names)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.imports[a.asname or a.name] = a.name
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.module_imports.add(
                        a.asname or a.name.split(".")[0])


def _held_module_locks(node, module: _Module) -> set[str]:
    """Module-level lock names held (via ``with``) at ``node``."""
    from .astutil import ancestors

    held: set[str] = set()
    for a in ancestors(node):
        if isinstance(a, ast.With):
            for item in a.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Name) and ctx.id in module.locks:
                    held.add(ctx.id)
    return held


def _self_synchronized(ctor: str, mod: _Module,
                       mods: dict[str, _Module],
                       _seen: frozenset = frozenset()) -> bool:
    """Is class ``ctor`` self-synchronized?  True when its __init__
    binds a lock attribute, or binds an attribute to another
    self-synchronized class (``ThreadSlots`` delegation)."""
    if ctor in _seen:
        return False
    cls = mod.classes.get(ctor)
    home = mod
    if cls is None:
        # imported class: resolve by name across analyzed modules
        for m in mods.values():
            if ctor in m.classes:
                cls, home = m.classes[ctor], m
                break
    if cls is None:
        return False
    init = next((n for n in cls.body
                 if isinstance(n, ast.FunctionDef)
                 and n.name == "__init__"), None)
    if init is None:
        return False
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            name = call_name(node.value)
            if name in _LOCK_CTORS or name == "local":
                return True
            if name and name[:1].isupper() and _self_synchronized(
                    name, home, mods, _seen | {ctor}):
                return True
    return False


# ----------------------------------------------------------------------
# Mutable-state findings
# ----------------------------------------------------------------------

def _state_findings(module: _Module,
                    mods: dict[str, _Module]) -> list[Finding]:
    findings: list[Finding] = []

    # unsynchronized module-level instances
    for name, (ctor, line) in sorted(module.instances.items()):
        if _self_synchronized(ctor, module, mods):
            continue
        findings.append(Finding(
            PASS, module.path, line, "unsynchronized-module-instance",
            name,
            f"module-level {name} = {ctor}(...) in a threaded module, "
            f"and {ctor} has no lock of its own — concurrent use "
            f"races unless every access is externally serialized "
            f"(allowlist with the reason if so)"))

    # unguarded rebinds of globals
    interesting = (set(module.scalars) | set(module.containers)
                   | set(module.instances)) & module.globals_
    for node in ast.walk(module.mod):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if not (isinstance(t, ast.Name) and t.id in interesting):
                continue
            fn = _enclosing_fn(node)
            if fn is None:
                continue  # the module-level definition itself
            if _held_module_locks(node, module):
                continue
            findings.append(Finding(
                PASS, module.path, node.lineno,
                "unlocked-global-rebind", t.id,
                f"global {t.id} rebound in {fn.name}() outside any "
                f"module lock — racing rebinds can lose one writer's "
                f"update (allowlist only if this is a deliberate "
                f"atomic reference swap)"))

    # unguarded container mutations
    for node in ast.walk(module.mod):
        name = mut = None
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.attr in _MUTATORS:
            name, mut = node.func.value.id, node.func.attr
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in tgts:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name):
                    name, mut = t.value.id, "[]="
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name):
                    name, mut = t.value.id, "del[]"
        if name is None or name not in module.containers:
            continue
        if _enclosing_fn(node) is None:
            continue  # import-time population is single-threaded
        if _held_module_locks(node, module):
            continue
        findings.append(Finding(
            PASS, module.path, node.lineno, "unlocked-module-state",
            name,
            f"module-level container {name} mutated (.{mut}) outside "
            f"any module lock in a threaded module — concurrent "
            f"mutation corrupts or loses entries"))
    return findings


def _enclosing_fn(node):
    from .astutil import enclosing_function

    return enclosing_function(node)


# ----------------------------------------------------------------------
# Whole-program lock-acquisition graph
# ----------------------------------------------------------------------
#
# Lock identity: (site, label, kind) where site == "path:lineno" of
# the threading ctor CALL node — the exact string lockcheck records
# at runtime.  The graph builder below is deliberately one big
# closure-free object so the --lock-graph export, the run() findings
# and the --verify-lockcheck comparison all read one memoized result.

_GRAPH_MEMO = "thread-safety/lock-graph"


class _ClassF:
    """Per-class facts for lock/type resolution."""

    def __init__(self, path: str, node: ast.ClassDef):
        self.path = path
        self.node = node
        self.name = node.name
        self.bases = [b.id for b in node.bases
                      if isinstance(b, ast.Name)]
        self.lock_attrs: dict[str, tuple] = {}   # attr -> (site, kind)
        self.attr_types: dict[str, str] = {}     # attr -> class name
        self.ret_types: dict[str, str] = {}      # method -> class name
        self.alias_assigns: list[tuple] = []     # (attr, value, fnkey)


def _ann_name(ann) -> str | None:
    """Type name out of an annotation node (``_IoHandle`` or
    ``"_IoHandle"`` — quoting is how reader.py forward-refs).  For a
    union (``RangeSourceFile | object``) the first CapWord component
    wins: the lock graph is a superset, so resolving the one repo
    facade in the union is what makes its lock edges visible —
    stdlib/opaque members contribute no repo locks anyway."""
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        parts = [p.strip() for p in ann.value.split("|")]
        for p in parts:
            if p and p[:1].isupper() and p.isidentifier():
                return p
        return parts[0] if parts and parts[0].isidentifier() else None
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _ann_name(ann.left) or _ann_name(ann.right)
    return None


def _is_atexit_register(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "register"
            and isinstance(f.value, ast.Name) and f.value.id == "atexit")


def _shallow_walk(root):
    """Walk ``root``'s subtree WITHOUT descending into nested
    function/class definitions (they are separate universe entries);
    lambdas ARE descended into — a lambda body runs as part of
    whatever invokes the enclosing function's callback."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class _Program:
    """Whole-program facts + the lock graph over the package."""

    def __init__(self, tree: RepoTree):
        self.tree = tree
        self.mods: dict[str, _Module] = {}
        self.classes: dict[str, list[_ClassF]] = {}  # name -> defs
        # function universe: key=(path, qualname)
        self.funcs: dict[tuple, tuple] = {}   # key -> (node, mod, clsF)
        self.parent: dict[tuple, tuple] = {}  # key -> enclosing fn key
        self.nested: dict[tuple, dict] = {}   # key -> {name: child key}
        self.top_by_name: dict[str, list] = {}
        self.method_index: dict[str, list] = {}
        self._localfacts: dict[tuple, tuple] = {}
        self.sites: dict[str, dict] = {}      # site -> {label, kind}
        # (a_site, b_site) -> (path, line, a_label, b_label)
        self.edges: dict[tuple, tuple] = {}
        self.unresolved: list[tuple] = []     # (path, line, expr, fn)
        self._subs: dict | None = None        # base name -> [_ClassF]
        self._build()

    # -- fact collection -------------------------------------------------

    def _build(self) -> None:
        for path, mod in self.tree.modules(PKG):
            self.mods[path] = _Module(path, mod)
        for path, m in self.mods.items():
            for cname, cls in m.classes.items():
                cf = _ClassF(path, cls)
                self._collect_class(cf, m)
                self.classes.setdefault(cname, []).append(cf)
        for path, m in self.mods.items():
            self._collect_funcs(path, m, m.mod.body, "", None, None)
        # module-level lock sites
        for path, m in self.mods.items():
            for node in m.mod.body:
                tgts, value = self._assign(node)
                kind = m._lock_kind(_ctor_name(value))
                if kind:
                    site = f"{path}:{value.lineno}"
                    for t in tgts:
                        self._add_site(site, self._label(path, t), kind)
                        m.locks.add(t)
        # alias resolution (one level: self.X = nh.lock etc.)
        for defs in self.classes.values():
            for cf in defs:
                for attr, value, fnkey in cf.alias_assigns:
                    lk = self._lock_of(value, fnkey)
                    if lk is not None:
                        cf.lock_attrs[attr] = lk
                        continue
                    t = self._type_of(value, fnkey)
                    if t is not None:
                        cf.attr_types[attr] = t
        self._build_graph()

    @staticmethod
    def _assign(node):
        if isinstance(node, ast.Assign):
            return ([t.id for t in node.targets
                     if isinstance(t, ast.Name)], node.value)
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            return ([node.target.id], node.value)
        return ([], None)

    @staticmethod
    def _label(path: str, qual: str) -> str:
        return f"{path.rsplit('/', 1)[-1]}:{qual}"

    def _add_site(self, site: str, label: str, kind: str) -> None:
        self.sites.setdefault(site, {"label": label, "kind": kind})

    def _collect_class(self, cf: _ClassF, m: _Module) -> None:
        for mnode in cf.node.body:
            if not isinstance(mnode, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            rt = _ann_name(mnode.returns)
            if rt:
                cf.ret_types[mnode.name] = rt
            fnkey = (cf.path, f"{cf.name}.{mnode.name}")
            for node in ast.walk(mnode):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    ctor = _ctor_name(node.value)
                    kind = m._lock_kind(ctor)
                    if kind:
                        site = f"{cf.path}:{node.value.lineno}"
                        label = self._label(
                            cf.path, f"{cf.name}.{t.attr}")
                        self._add_site(site, label, kind)
                        cf.lock_attrs[t.attr] = (site, kind)
                    elif ctor and ctor.lstrip("_")[:1].isupper():
                        # CapWord possibly behind a privacy prefix:
                        # ``self._pool = _HttpConnPool(...)`` must
                        # type the attr or the pool's lock reach
                        # (its Condition) vanishes from the graph
                        cf.attr_types[t.attr] = ctor
                    elif isinstance(node.value,
                                    (ast.Attribute, ast.Name)):
                        cf.alias_assigns.append(
                            (t.attr, node.value, fnkey))

    def _collect_funcs(self, path, m, body, prefix, cls, parent):
        for node in body:
            if isinstance(node, ast.ClassDef):
                cf = next((c for c in self.classes.get(node.name, ())
                           if c.path == path and c.node is node), None)
                self._collect_funcs(path, m, node.body,
                                    f"{prefix}{node.name}.", cf, parent)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                key = (path, f"{prefix}{node.name}")
                self.funcs[key] = (node, m, cls)
                if parent is not None:
                    self.parent[key] = parent
                    self.nested.setdefault(parent, {})[node.name] = key
                if prefix == "":
                    self.top_by_name.setdefault(
                        node.name, []).append(key)
                elif cls is not None and \
                        prefix == f"{cls.name}." and \
                        node.name not in _GENERIC_METHODS:
                    self.method_index.setdefault(
                        node.name, []).append(key)
                # nested defs inherit the class context: closures over
                # ``self`` are how pool tasks reach instance locks
                self._collect_funcs(
                    path, m, node.body,
                    f"{prefix}{node.name}.<locals>.", cls, key)

    # -- type / lock resolution ------------------------------------------

    def _class_of(self, name: str | None, path: str) -> "_ClassF | None":
        if not name:
            return None
        defs = self.classes.get(name) or []
        for cf in defs:
            if cf.path == path:
                return cf
        return defs[0] if defs else None

    def _subclasses(self) -> dict:
        subs = self._subs
        if subs is None:
            subs = {}
            for defs in self.classes.values():
                for cf in defs:
                    for b in cf.bases:
                        subs.setdefault(b, []).append(cf)
            self._subs = subs
        return subs

    def _virtual(self, cf: "_ClassF", attr: str) -> list:
        """Method keys for ``attr`` as seen from static type ``cf``:
        the definition found up the base chain PLUS every override in
        transitive subclasses.  A call through a base-typed reference
        dispatches to whichever override the runtime object carries
        (``ByteRangeSource.get_range`` runs a subclass ``_read_raw``),
        so every override must contribute its lock reach."""
        out: list = []
        base, seen = cf, set()
        while base is not None and base.name not in seen:
            seen.add(base.name)
            key = (base.path, f"{base.name}.{attr}")
            if key in self.funcs:
                out.append(key)
                break
            base = self._class_of(
                base.bases[0] if base.bases else None, base.path)
        stack, walked = [cf.name], set()
        while stack:
            n = stack.pop()
            if n in walked:
                continue
            walked.add(n)
            for sub in self._subclasses().get(n, ()):
                key = (sub.path, f"{sub.name}.{attr}")
                if key in self.funcs and key not in out:
                    out.append(key)
                stack.append(sub.name)
        return out

    def _class_lock(self, cf: "_ClassF | None", attr: str,
                    _seen=()) -> tuple | None:
        while cf is not None and cf not in _seen:
            if attr in cf.lock_attrs:
                return cf.lock_attrs[attr]
            _seen = _seen + (cf,)
            cf = self._class_of(cf.bases[0] if cf.bases else None,
                                cf.path)
        return None

    def _class_type(self, cf: "_ClassF | None", attr: str) -> str | None:
        while cf is not None:
            if attr in cf.attr_types:
                return cf.attr_types[attr]
            cf = self._class_of(cf.bases[0] if cf.bases else None,
                                cf.path)
        return None

    def _local_facts(self, fnkey) -> tuple:
        """(param+local types, local lock aliases) for one function."""
        if fnkey in self._localfacts:
            return self._localfacts[fnkey]
        fn, m, cls = self.funcs[fnkey]
        types: dict[str, str] = {}
        locks: dict[str, tuple] = {}
        self._localfacts[fnkey] = (types, locks)  # break self-cycles
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            t = _ann_name(a.annotation)
            if t:
                types[a.arg] = t
        for node in _shallow_walk(fn):
            if not isinstance(node, ast.Assign) or \
                    len(node.targets) != 1 or \
                    not isinstance(node.targets[0], ast.Name):
                continue
            name = node.targets[0].id
            lk = self._lock_of(node.value, fnkey, _local=(types, locks))
            if lk is not None:
                locks[name] = lk
                continue
            t = self._type_of(node.value, fnkey,
                              _local=(types, locks))
            if t is not None:
                types[name] = t
        return self._localfacts[fnkey]

    def _type_of(self, expr, fnkey, _local=None) -> str | None:
        fn, m, cls = self.funcs[fnkey]
        types = (_local or self._local_facts(fnkey))[0]
        if isinstance(expr, ast.Name):
            if expr.id == "self" and cls is not None:
                return cls.name
            if expr.id in types:
                return types[expr.id]
            inst = m.instances.get(expr.id)
            if inst:
                return inst[0]
            return m.annotated.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._type_of(expr.value, fnkey, _local=_local)
            return self._class_type(self._class_of(base, m.path),
                                    expr.attr)
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name and self.classes.get(name):
                return name
            # annotated return of a resolvable method/function
            f = expr.func
            if isinstance(f, ast.Name):
                # a module-level function of this module
                for key in self.top_by_name.get(f.id, ()):
                    if key[0] == m.path:
                        rt = _ann_name(self.funcs[key][0].returns)
                        if rt:
                            return rt
            if isinstance(f, ast.Attribute):
                base = self._type_of(f.value, fnkey, _local=_local)
                cf = self._class_of(base, m.path)
                while cf is not None:
                    if f.attr in cf.ret_types:
                        return cf.ret_types[f.attr]
                    cf = self._class_of(
                        cf.bases[0] if cf.bases else None, cf.path)
        return None

    def _lock_of(self, expr, fnkey, _local=None) -> tuple | None:
        """(site, kind) of a lock-valued expression, or None."""
        fn, m, cls = self.funcs[fnkey]
        if isinstance(expr, ast.Name):
            locks = (_local or self._local_facts(fnkey))[1]
            if expr.id in locks:
                return locks[expr.id]
            if expr.id in m.locks:
                site = self._module_lock_site(m.path, expr.id)
                if site:
                    return site
            src = m.imports.get(expr.id)
            if src:
                for om in self.mods.values():
                    if src in om.locks:
                        site = self._module_lock_site(om.path, src)
                        if site:
                            return site
            return None
        if isinstance(expr, ast.Attribute):
            # module-alias attribute: rangecache._LOCK
            if isinstance(expr.value, ast.Name):
                alias = expr.value.id
                src = m.imports.get(alias)
                for om in self.mods.values():
                    if om.path.rsplit("/", 1)[-1][:-3] in (alias, src) \
                            and expr.attr in om.locks:
                        site = self._module_lock_site(om.path,
                                                      expr.attr)
                        if site:
                            return site
            base = self._type_of(expr.value, fnkey, _local=_local)
            return self._class_lock(self._class_of(base, m.path),
                                    expr.attr)
        return None

    def _module_lock_site(self, path: str, name: str) -> tuple | None:
        label = self._label(path, name)
        for site, info in self.sites.items():
            if info["label"] == label and site.startswith(path + ":"):
                return (site, info["kind"])
        return None

    # -- call resolution -------------------------------------------------

    def _resolve_ref(self, expr, fnkey) -> list:
        """Function keys an expression may refer to (no fanout)."""
        fn, m, cls = self.funcs[fnkey]
        if isinstance(expr, ast.Name):
            # lexical scope chain: nested defs of this fn, then of the
            # enclosing fns, then module level, then imports
            k = fnkey
            while k is not None:
                child = self.nested.get(k, {}).get(expr.id)
                if child:
                    return [child]
                k = self.parent.get(k)
            if (m.path, expr.id) in self.funcs:
                return [(m.path, expr.id)]
            src = m.imports.get(expr.id)
            if src:
                return [key for key in self.top_by_name.get(src, ())]
            return []
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and cls is not None:
                return self._virtual(cls, expr.attr)
            t = self._type_of(expr.value, fnkey)
            cf = self._class_of(t, m.path)
            if cf is not None:
                keys = self._virtual(cf, expr.attr)
                if keys:
                    return keys
            if isinstance(expr.value, ast.Name):
                # imported-module function: faults.retry_transient
                alias = expr.value.id
                src = m.imports.get(alias, alias)
                for om_path in self.mods:
                    if om_path.rsplit("/", 1)[-1][:-3] in (alias, src):
                        key = (om_path, expr.attr)
                        if key in self.funcs:
                            return [key]
            return []
        return []

    def _callees(self, call: ast.Call, fnkey) -> list:
        fn, m, cls = self.funcs[fnkey]
        out = self._resolve_ref(call.func, fnkey)
        if not out and isinstance(call.func, ast.Attribute) and \
                call.func.attr not in _GENERIC_METHODS and \
                not (isinstance(call.func.value, ast.Name)
                     and call.func.value.id in m.module_imports):
            out = list(self.method_index.get(call.func.attr, ()))
        # function-valued arguments: submit(_task), Thread(target=fn),
        # retry_transient(_one) — treated as potential invocations so
        # pool-mediated acquisition stays visible; an exit handler
        # (``atexit.register(fn)``) runs at interpreter exit, never
        # under the registering frame's locks, nor waited for by it
        if _is_atexit_register(call):
            return out
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, (ast.Name, ast.Attribute)):
                out.extend(self._resolve_ref(arg, fnkey))
        return out

    # -- graph -----------------------------------------------------------

    def _with_locks(self, w: ast.With, fnkey) -> list:
        """Resolved (site, kind) per with-item; records unresolved
        lockish expressions."""
        fn, m, cls = self.funcs[fnkey]
        out = []
        for item in w.items:
            ctx = item.context_expr
            if not isinstance(ctx, (ast.Name, ast.Attribute)):
                continue
            lk = self._lock_of(ctx, fnkey)
            if lk is not None:
                out.append(lk)
                continue
            leaf = ctx.id if isinstance(ctx, ast.Name) else ctx.attr
            low = leaf.lower()
            if any(p in low for p in _LOCKISH):
                self.unresolved.append(
                    (m.path, ctx.lineno, ast.unparse(ctx),
                     fnkey[1]))
        return out

    def _build_graph(self) -> None:
        callees: dict[tuple, set] = {}
        reach: dict[tuple, set] = {}
        for fnkey, (fn, m, cls) in self.funcs.items():
            outs: set = set()
            direct: set = set()
            for node in _shallow_walk(fn):
                if isinstance(node, ast.Call):
                    outs.update(self._callees(node, fnkey))
                elif isinstance(node, ast.With):
                    direct.update(self._with_locks(node, fnkey))
            callees[fnkey] = outs
            reach[fnkey] = direct
        # fixpoint over the whole call graph — recursion with
        # memoization would cache cycle-truncated partial results for
        # mutually recursive functions and silently hide edges (and
        # with them, deadlock cycles)
        changed = True
        while changed:
            changed = False
            for fnkey, outs in callees.items():
                r = reach[fnkey]
                before = len(r)
                for c in outs:
                    r |= reach.get(c, set())
                if len(r) != before:
                    changed = True
        # edges: for every with-block, held -> (nested acquires +
        # everything reachable through calls inside the block)
        for fnkey, (fn, m, cls) in self.funcs.items():
            for node in _shallow_walk(fn):
                if not isinstance(node, ast.With):
                    continue
                held = self._with_locks(node, fnkey)
                if not held:
                    continue
                acquired: set = set()
                for stmt in node.body:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                        continue
                    for sub in [stmt] + list(_shallow_walk(stmt)):
                        if isinstance(sub, ast.With):
                            acquired.update(
                                self._with_locks(sub, fnkey))
                        elif isinstance(sub, ast.Call):
                            for c in self._callees(sub, fnkey):
                                acquired |= reach.get(c, set())
                for a_site, a_kind in held:
                    for b_site, b_kind in acquired:
                        key = (a_site, b_site)
                        if key not in self.edges:
                            self.edges[key] = (
                                m.path, node.lineno,
                                self.sites[a_site]["label"],
                                self.sites[b_site]["label"])

    # -- verdicts --------------------------------------------------------

    def cycles(self) -> list:
        """Cycles over the edge set; self-loops only for
        non-reentrant kinds."""
        graph: dict[str, set] = {}
        for (a, b) in self.edges:
            if a == b:
                if self.sites[a]["kind"] in _REENTRANT_KINDS:
                    continue
                graph.setdefault(a, set()).add(b)
            else:
                graph.setdefault(a, set()).add(b)
        cycles: list[list] = []
        seen: set = set()

        def dfs(start, node, stack, visited):
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = frozenset(stack)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(list(stack) + [start])
                elif nxt not in visited and len(stack) < 8:
                    visited.add(nxt)
                    dfs(start, nxt, stack + [nxt], visited)
        for n in sorted(graph):
            dfs(n, n, [n], {n})
        return cycles


def _program(tree: RepoTree) -> _Program:
    prog = tree.memo.get(_GRAPH_MEMO)
    if prog is None:
        prog = tree.memo[_GRAPH_MEMO] = _Program(tree)
    return prog


def static_graph(tree: RepoTree) -> dict:
    """The whole-program lock graph as one JSON-able document —
    the reference the runtime recorder's dump is verified against."""
    prog = _program(tree)
    return {
        "sites": {s: dict(info) for s, info in
                  sorted(prog.sites.items())},
        "edges": sorted([a, b] for (a, b) in prog.edges),
        "unresolved": [
            {"file": p, "line": ln, "expr": e, "function": fn}
            for p, ln, e, fn in sorted(set(prog.unresolved))],
    }


def verify_runtime_graph(tree: RepoTree, recorded: dict) -> list[str]:
    """Check a ``lockcheck`` dump against the static graph: recorded
    repo-lock edges must be a SUBSET of the static edges (else the
    static analysis failed to model a real call path), and the
    recorded graph must carry no cycle violations.  Returns problem
    strings (empty = verified).  Only edges with both endpoints in
    the package are compared — test/tool locks are recorded for
    the cycle check but have no static counterpart here."""
    prog = _program(tree)
    problems = []
    for v in recorded.get("violations") or []:
        problems.append(f"runtime violation: {v}")
    static_edges = set(map(tuple, (static_graph(tree)["edges"])))
    for entry in recorded.get("edges") or []:
        a, b = entry[0], entry[1]
        if not (a.startswith(PKG) and b.startswith(PKG)):
            continue
        if a == b:
            continue  # same creation site: no order within one site
        if (a, b) not in static_edges:
            problems.append(
                f"recorded edge {a} -> {b} absent from the static "
                f"lock graph — the analysis is missing a call path")
    return problems


def threaded_modules(tree: RepoTree) -> list[str]:
    out = []
    for path, mod in tree.modules(PKG):
        if _imports_threading(mod):
            out.append(path)
    return out


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    mods: dict[str, _Module] = {}
    for path, mod in tree.modules(PKG):
        if _imports_threading(mod):
            mods[path] = _Module(path, mod)
    for m in mods.values():
        findings.extend(_state_findings(m, mods))
    prog = _program(tree)
    for path, line, expr, fn in sorted(set(prog.unresolved)):
        findings.append(Finding(
            PASS, path, line, "unresolved-lock-with", expr,
            f"`with {expr}:` in {fn}() looks like a lock acquisition "
            f"the analyzer cannot resolve to a creation site — the "
            f"lock graph would silently miss its edges; name the "
            f"lock via an attribute/annotation the pass can follow, "
            f"or allowlist with the reason"))
    for cyc in prog.cycles():
        names = " -> ".join(prog.sites[s]["label"] for s in cyc)
        path, line = cyc[0].rsplit(":", 1)
        findings.append(Finding(
            PASS, path, int(line), "lock-cycle", names,
            f"static lock-acquisition cycle {names} — two threads "
            f"entering from different ends deadlock (threading.Lock "
            f"is not reentrant, so a self-loop deadlocks one thread "
            f"alone; RLock/Condition self-loops are exempt)"))
    return findings
