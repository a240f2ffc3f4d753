"""Minimal ASCII table (a PrettyTable replacement), the port's copy of
zedo_tpu/utils/table.py: the box style of the reference's eval reports."""
from __future__ import annotations


class Table:
    def __init__(self, field_names):
        self.field_names = [str(f) for f in field_names]
        self.rows: list[list[str]] = []

    def add_row(self, row):
        if len(row) != len(self.field_names):
            raise ValueError(f"row of {len(row)} cells for {len(self.field_names)} fields")
        self.rows.append([str(c) for c in row])

    def __str__(self) -> str:
        widths = [
            max(len(self.field_names[i]), *(len(r[i]) for r in self.rows))
            if self.rows
            else len(self.field_names[i])
            for i in range(len(self.field_names))
        ]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        def fmt(cells):
            return "| " + " | ".join(c.center(w) for c, w in zip(cells, widths)) + " |"
        lines = [sep, fmt(self.field_names), sep]
        lines += [fmt(r) for r in self.rows]
        lines.append(sep)
        return "\n".join(lines)
