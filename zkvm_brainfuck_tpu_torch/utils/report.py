"""Execution report tables (reference: crates/core/executor/src/events/utils.rs)."""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Tuple


def sorted_table_lines(table: Dict[str, int]) -> Tuple[int, list]:
    """Sort by count desc then label asc; returns (count column width, rows)."""
    entries = sorted(table.items(), key=lambda kv: (-kv[1], kv[0]))
    entries = [(label.lower(), count) for label, count in entries]
    width = len(str(entries[0][1])) if entries else 0
    return width, entries


def format_table_line(width: int, label: str, count) -> str:
    return f"{count:>{width}} {label}"


def generate_execution_report(table: Dict[str, int]) -> Iterator[str]:
    width, lines = sorted_table_lines(table)
    for label, count in lines:
        if count != 0:
            yield f"  {format_table_line(width, label, count)}"
