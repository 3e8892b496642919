"""Hierarchical instruction-count spans (reference: utils/span.rs).

Build nested spans while replaying a program trace and accumulate per-opcode
counts; `lines()` renders the tree with counts, like the reference's
`Span::lines` (span.rs:68-113).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Span:
    name: str
    cnt: Dict[str, int] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    def add(self, item: str, count: int = 1):
        self.cnt[item] = self.cnt.get(item, 0) + count

    def total(self) -> int:
        return sum(self.cnt.values()) + sum(c.total() for c in self.children)

    def lines(self) -> List[str]:
        out = [f"{self.name}"]
        for child in self.children:
            out.extend("  " + l for l in child.lines())
        for item in sorted(self.cnt):
            out.append(f"  {self.cnt[item]:>8} {item}")
        out.append(f"  {self.total():>8} total")
        return out


class SpanBuilder:
    """Enter/exit nested spans; items accumulate in the current span."""

    def __init__(self, root: str = "root"):
        self.stack = [Span(root)]

    @property
    def current(self) -> Span:
        return self.stack[-1]

    def enter(self, name: str):
        s = Span(name)
        self.current.children.append(s)
        self.stack.append(s)
        return self

    def item(self, name: str, count: int = 1):
        self.current.add(name, count)
        return self

    def exit(self):
        assert len(self.stack) > 1, "cannot exit the root span"
        self.stack.pop()
        return self

    def finish(self) -> Span:
        assert len(self.stack) == 1, "unclosed spans"
        return self.stack[0]
