"""Column-layout DSL: the Python counterpart of `#[derive(AlignedBorrow)]`.

The reference maps flat trace rows onto typed column structs with an unsafe
borrow (crates/derive/src/lib.rs:32-89).  Here a `Layout` declares named
scalar / vector / nested fields over the last axis of a trace matrix, and
provides:
- `width`: flattened column count
- `view(get)`: a namespace of wrapped values for constraint evaluation, where
  `get(i)` yields the builder's value for column i (array slice, symbolic var,
  or opened EF scalar)
- `assemble(cols)`: stack a dict of per-field arrays into an (N, width) matrix
  for trace generation (torch, on the columns' device)
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple, Union

import torch

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

    def offset_of(self, dotted: str) -> int:
        """Column offset for 'a.b.c' or 'a.b[2]' style paths."""
        parts = dotted.split(".")
        lay, off = self, 0
        for i, part in enumerate(parts):
            idx = None
            if "[" in part:
                part, rest = part.split("[")
                idx = int(rest.rstrip("]"))
            o, spec = lay.index[part]
            off += o
            if isinstance(spec, tuple):  # (count, Layout) array of structs
                cnt, sub = spec
                assert idx is not None
                off += idx * sub.width
                lay = sub
            elif isinstance(spec, Layout):
                assert idx is None
                lay = spec
            else:
                if idx is not None:
                    off += idx
                assert i == len(parts) - 1
        return off

    def view(self, get):
        ns = SimpleNamespace()
        for name, spec in self.fields:
            off, _ = self.index[name]
            setattr(ns, name, _build_view(spec, off, get))
        return ns

    def assemble(self, cols: Dict[str, object], n: int):
        """cols maps dotted scalar paths -> (N,) tensors; missing fields are
        0.  Returns an (N, width) int32 matrix on the columns' device."""
        parts = [None] * self.width
        for path, arr in cols.items():
            parts[self.offset_of(path)] = arr
        device = next(p.device for p in parts if p is not None)
        zero = torch.zeros((n,), dtype=torch.int32, device=device)
        parts = [zero if p is None else p.to(torch.int32) for p in parts]
        return torch.stack(parts, dim=1)

    def scalar_paths(self) -> List[str]:
        out = []

        def walk(lay: Layout, prefix: str):
            for name, spec in lay.fields:
                p = f"{prefix}{name}"
                if isinstance(spec, int):
                    if spec == 1:
                        out.append(p)
                    else:
                        out.extend(f"{p}[{i}]" for i in range(spec))
                elif isinstance(spec, Layout):
                    walk(spec, p + ".")
                else:
                    cnt, sub = spec
                    for i in range(cnt):
                        walk(sub, f"{p}[{i}].")

        walk(self, "")
        return out


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
