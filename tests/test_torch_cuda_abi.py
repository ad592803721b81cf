"""The argument structs of the port's CUDA kernels against their ctypes
mirrors, on the CPU: each kernel's C entry takes one struct
(`<kernel>_launch(const <X>Args*, cudaStream_t)`), and csrc/build.py
`launch` fills the Python mirror field by field. The card checks only the
total size (`<kernel>_args_size`), so two fields of one kind in another
order would pass it and hand the kernel the wrong tensors; this test reads
`struct <X>Args { ... };` from the source and holds the names, the order
and the kind (int, float, pointer, float array) of its fields to the
mirror's `_fields_`.
"""

import ctypes
import os
import re

import pytest

from gfxexp_torch.accel import instanced, lanegroup, persistent, qrow
from gfxexp_torch.accel import skip_traverse
from gfxexp_torch.csrc.build import header_constant
from gfxexp_torch.render import pathtrace
from gfxexp_torch.techniques import restir_di

CSRC = os.path.join(os.path.dirname(persistent.__file__), "..", "csrc")

# (source, struct, ctypes mirror): every kernel launched through
# build.launch
STRUCTS = [
    ("widerow_traverse.cu", "WiderowArgs", persistent._WiderowArgs),
    ("chunked_traverse.cu", "ChunkedArgs", persistent._ChunkedArgs),
    ("instanced_traverse.cu", "InstancedArgs", instanced._InstancedArgs),
    ("qrow_traverse.cu", "QrowArgs", qrow._QrowArgs),
    ("lanegroup_traverse.cu", "LanegroupArgs", lanegroup._LanegroupArgs),
    ("skiplink_traverse.cu", "SkiplinkArgs", skip_traverse._SkiplinkArgs),
    ("shade_bounce.cu", "ShadeArgs", pathtrace._ShadeArgs),
    ("restir_resample.cu", "InitialArgs", restir_di._InitialArgs),
    ("restir_resample.cu", "SpatialArgs", restir_di._SpatialArgs),
]

_SCALARS = {"int": "int", "float": "float"}
_CTYPES = {ctypes.c_int: "int", ctypes.c_float: "float",
           ctypes.c_void_p: "pointer"}


def c_fields(source: str, struct: str) -> list:
    """[(name, kind)] of `struct <struct> { ... };` in csrc/<source>: kind
    "pointer", "int", "float", or ("float", N) for an array."""
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(rf"^struct {struct} \{{\n(.*?)^\}};", f.read(),
                      re.S | re.M)
    assert m is not None, f"no struct {struct} in {source}"
    body = re.sub(r"//[^\n]*", "", m.group(1))
    fields = []
    for decl in filter(None, (" ".join(d.split()) for d in body.split(";"))):
        t = re.fullmatch(r"(?:const )?(?:unsigned )?(\w+)\s*(.*)", decl)
        assert t is not None, decl
        for declarator in t.group(2).split(","):
            d = re.fullmatch(r"\s*(\*?)\s*(\w+)\s*(?:\[(\w+)\])?\s*",
                             declarator)
            assert d is not None, decl
            star, name, length = d.groups()
            if star:
                kind = "pointer"
            else:
                kind = _SCALARS[t.group(1)]
                if length is not None:
                    kind = (kind, int(length) if length.isdigit()
                            else header_constant(length, source))
            fields.append((name, kind))
    return fields


def py_fields(args_type) -> list:
    """[(name, kind)] of a ctypes Structure, in c_fields' terms."""
    out = []
    for name, t in args_type._fields_:
        if issubclass(t, ctypes.Array):
            out.append((name, (_CTYPES[t._type_], t._length_)))
        else:
            out.append((name, _CTYPES[t]))
    return out


@pytest.mark.parametrize("source,struct,args_type", STRUCTS,
                         ids=[s for _, s, _ in STRUCTS])
def test_struct_mirrors_kernel(source, struct, args_type):
    c = c_fields(source, struct)
    assert c, f"{struct} has no fields"
    assert py_fields(args_type) == c
