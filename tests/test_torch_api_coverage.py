"""The public surface of gfxexp_tpu/ against gfxexp_torch/, read from the
sources with `ast` (neither package is imported).

Every public top-level function, class and upper-case constant of every
module of the JAX package has a counterpart of the same name somewhere in
the port, and every public method, property and field of a class both
packages define has one in the port's class. A name without one is in
RENAMED (its counterpart under another name, checked to exist) or in
NOT_PORTED (the reason). A new JAX name with neither fails here, as does an
entry for a name that the port now has. No public function of the port
defaults `device` to the CPU, apart from those DEVICE_CPU lists."""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = REPO / "gfxexp_tpu"
PORT = REPO / "gfxexp_torch"

# JAX name -> (port module, port name): the same job under another name
RENAMED = {
    "intersect_closest_persistent": ("accel/persistent.py",
                                     "intersect_closest_widerow"),
    "intersect_any_persistent": ("accel/persistent.py",
                                 "intersect_any_widerow"),
    "intersect_closest_widestack": ("accel/persistent.py",
                                    "intersect_closest_widerow"),
    "intersect_any_widestack": ("accel/persistent.py",
                                "intersect_any_widerow"),
    # the nearest-first route of the two-level walk
    "intersect_closest_persistent_inst": ("accel/instanced.py",
                                          "intersect_closest_instanced"),
    "intersect_any_persistent_inst": ("accel/instanced.py",
                                      "intersect_any_instanced"),
    # the skip-link walk in plain array ops (the JAX package's jnp walk)
    "intersect_closest_skip": ("accel/skiplink.py", "walk_skip_plain"),
    "intersect_any_skip": ("accel/skiplink.py", "walk_skip_plain"),
    # optax's chain (weight decay, Adam, -lr) written out: optax is not on
    # the card's machine
    "make_optimizer": ("techniques/nrc/network.py", "apply_step"),
}

# JAX name -> why the port has no counterpart
NOT_PORTED = {
    "intersect_closest_tiled": "accel/tiled.py, the CPU stand-in for the "
                               "skip walk: Not to port (ROADMAP)",
    "intersect_any_tiled": "accel/tiled.py: Not to port (ROADMAP)",
    "DEFAULT_TILE": "accel/tiled.py's tile: Not to port (ROADMAP)",
    "ROWS": "the TPU kernels' tiles of 128-ray rows (pallas_widestack.py, "
            "pallas_rowcursor.py); the CUDA walks run a thread per ray",
    "TILE": "the TPU skip walk's rays per tile (pallas_traverse.py): the "
            "TPU layout, not the semantics",
    "SCHED_K": "the TPU persistent kernel's refill schedule "
               "(pallas_persistent.py): the TPU layout; kernel 1 refills "
               "per lane",
    "F32": "an alias of jnp.float32: the port names torch.float32",
    "U32": "an alias of jnp.uint32: the port carries uint32 bits in int32 "
           "tensors (core/rng.py)",
    "AXIS": "the name of jax.sharding's mesh axis: torch.distributed has no "
            "named axes (parallel/sharding.py Mesh)",
}

# "Class.member" -> why the port's class has no counterpart
MEMBERS_NOT_PORTED: dict = {}

# "module:function" -> why its `device` defaults to the CPU
DEVICE_CPU: dict = {}


def _modules(pkg):
    for path in sorted(pkg.rglob("*.py")):
        yield str(path.relative_to(pkg)), ast.parse(path.read_text())


def _top_names(node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _public(name):
    return not name.startswith("_")


def _surface(pkg, constants_upper_only=True):
    """({name: [modules]} of the public top-level functions, classes and
    upper-case constants; {class: {public methods, properties, fields}})."""
    names, classes = {}, {}
    for mod, tree in _modules(pkg):
        for node in tree.body:
            for name in _top_names(node):
                if not _public(name):
                    continue
                if (isinstance(node, (ast.Assign, ast.AnnAssign))
                        and constants_upper_only and not name.isupper()):
                    continue
                names.setdefault(name, []).append(mod)
            if isinstance(node, ast.ClassDef) and _public(node.name):
                members = classes.setdefault(node.name, set())
                for item in node.body:
                    members.update(n for n in _top_names(item)
                                   if _public(n) and not isinstance(
                                       item, ast.ClassDef))
    return names, classes


JAX_NAMES, JAX_CLASSES = _surface(JAX)
PORT_NAMES, PORT_CLASSES = _surface(PORT, constants_upper_only=False)


def test_every_public_name_has_a_counterpart():
    missing = sorted(f"{mods[0]}: {name}" for name, mods in JAX_NAMES.items()
                     if name not in PORT_NAMES and name not in RENAMED
                     and name not in NOT_PORTED)
    assert not missing, ("JAX names with no counterpart in gfxexp_torch/ "
                         "(port them, or add a RENAMED or NOT_PORTED entry): "
                         f"{missing}")


def test_every_member_of_a_shared_class_has_a_counterpart():
    shared = sorted(set(JAX_CLASSES) & set(PORT_CLASSES))
    assert shared
    missing = sorted(f"{c}.{m}" for c in shared
                     for m in JAX_CLASSES[c] - PORT_CLASSES[c]
                     if f"{c}.{m}" not in MEMBERS_NOT_PORTED)
    assert not missing, missing


def test_table_entries_are_live():
    """Each entry names a public JAX name the port lacks; each renamed
    counterpart is a top-level name of the port module given."""
    for table in (RENAMED, NOT_PORTED):
        for name in table:
            assert name in JAX_NAMES, f"{name}: no longer in gfxexp_tpu/"
            assert name not in PORT_NAMES, f"{name}: the port has it now"
    for name, (mod, target) in RENAMED.items():
        tree = ast.parse((PORT / mod).read_text())
        assert any(target in _top_names(n) for n in tree.body), (name, mod,
                                                                 target)
    assert all(reason.strip() for reason in NOT_PORTED.values())
    for key in MEMBERS_NOT_PORTED:
        cls, member = key.split(".")
        assert member in JAX_CLASSES[cls] - PORT_CLASSES.get(cls, set()), key


def _cpu_default(node):
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    # torch.device("cpu")
    return (isinstance(node, ast.Call) and len(node.args) == 1
            and getattr(node.func, "attr", None) == "device"
            and _cpu_default(node.args[0]))


def test_no_public_function_defaults_device_to_cpu():
    """The port runs on the card unless the caller asks for the CPU."""
    found = set()
    for mod, tree in _modules(PORT):
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = node.args
            pairs = list(zip(args.args[len(args.args) - len(args.defaults):],
                             args.defaults))
            pairs += [(a, d) for a, d in zip(args.kwonlyargs,
                                             args.kw_defaults) if d]
            if any(a.arg == "device" and _cpu_default(d) for a, d in pairs):
                found.add(f"{mod}:{node.name}")
    public = {f for f in found if _public(f.split(":")[1])}
    assert public <= set(DEVICE_CPU), sorted(public - set(DEVICE_CPU))
    assert set(DEVICE_CPU) <= found, "stale DEVICE_CPU entries"
