"""Column-layout DSL: the Python counterpart of `#[derive(AlignedBorrow)]`.

The reference maps flat trace rows onto typed column structs with an unsafe
borrow (crates/derive/src/lib.rs:32-89).  Here a `Layout` declares named
scalar / vector / nested fields over the last axis of a trace matrix, and
provides:
- `width`: flattened column count
- `view(get)`: a namespace of wrapped values for constraint evaluation, where
  `get(i)` yields the builder's value for column i (array slice, symbolic var,
  or opened EF scalar)
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple, Union

FieldSpec = Union[int, "Layout", Tuple[int, "Layout"]]


class Layout:
    def __init__(self, fields: List[Tuple[str, FieldSpec]]):
        self.fields = fields
        self.index: Dict[str, Tuple[int, FieldSpec]] = {}
        off = 0
        for name, spec in fields:
            self.index[name] = (off, spec)
            off += _spec_width(spec)
        self.width = off

    def view(self, get):
        ns = SimpleNamespace()
        for name, spec in self.fields:
            off, _ = self.index[name]
            setattr(ns, name, _build_view(spec, off, get))
        return ns


def _spec_width(spec: FieldSpec) -> int:
    if isinstance(spec, int):
        return spec
    if isinstance(spec, Layout):
        return spec.width
    cnt, sub = spec
    return cnt * sub.width


def _build_view(spec: FieldSpec, off: int, get):
    if isinstance(spec, int):
        if spec == 1:
            return get(off)
        return [get(off + i) for i in range(spec)]
    if isinstance(spec, Layout):
        return spec.view(lambda i: get(off + i))
    cnt, sub = spec
    return [sub.view(lambda i, k=k: get(off + k * sub.width + i)) for k in range(cnt)]
