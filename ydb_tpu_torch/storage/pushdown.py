"""Extract min/max prune predicates from an SSA program.

The scan path runs the full program on-device per block; this module only
mines the program's *leading* Filter commands for `col <op> const` conjuncts
usable against portion statistics — the analog of the reference's
early-filter planning (`engines/reader/plain_reader/constructor/`,
`TPredicateFilter`).
"""

from __future__ import annotations

from ydb_tpu_torch.ops import ir

_CMP = {"eq", "lt", "le", "gt", "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _conjuncts(expr, out):
    if isinstance(expr, ir.Call) and expr.op == "and":
        for a in expr.args:
            _conjuncts(a, out)
    else:
        out.append(expr)


def extract_prune_predicates(program: ir.Program) -> list[tuple]:
    """[(col, op, value)] conjuncts implied by the program's filters."""
    preds: list[tuple] = []
    assigned: set[str] = set()
    for cmd in program.commands:
        if isinstance(cmd, ir.Assign):
            assigned.add(cmd.name)
        elif isinstance(cmd, ir.Filter):
            parts: list = []
            _conjuncts(cmd.pred, parts)
            for p in parts:
                if not (isinstance(p, ir.Call) and p.op in _CMP and len(p.args) == 2):
                    continue
                a, b = p.args
                if isinstance(a, ir.Col) and isinstance(b, ir.Const):
                    col, op, val = a.name, p.op, b.value
                elif isinstance(a, ir.Const) and isinstance(b, ir.Col):
                    col, op, val = b.name, _FLIP[p.op], a.value
                else:
                    continue
                if col not in assigned:  # only source columns have stats
                    preds.append((col, op, val))
        elif isinstance(cmd, (ir.GroupBy,)):
            break
    return preds
