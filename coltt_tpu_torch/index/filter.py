"""Composable filter-expression language.

Reference parity: ``pkg/inverted/filter.go:40-93`` (``Filter{IndexName, Op,
Value}`` / ``FilterExpression`` with AND/OR composites) and the proto tree
``idl/proto/v4/edge.proto`` (SearchFilter / CompositeFilter /
FilterExpression / Op / LogicalOperator). The engine-side conversion from
the proto tree mirrors ``edge/edge_analyzer.go:150-192`` (queryExprAnalyzer).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence, Union


class Op(enum.IntEnum):
    """Matches proto enum Op (idl/proto/v4/edge.proto)."""

    EQ = 0
    NEQ = 1
    GT = 2
    GTE = 3
    LT = 4
    LTE = 5

    @classmethod
    def parse(cls, v) -> "Op":
        if isinstance(v, Op):
            return v
        if isinstance(v, str):
            symbolic = {"==": "EQ", "!=": "NEQ", ">": "GT", ">=": "GTE",
                        "<": "LT", "<=": "LTE"}
            key = symbolic.get(v.strip(), v.strip().upper())
            return cls[key]
        return cls(int(v))


class LogicalOp(enum.IntEnum):
    """Matches proto enum LogicalOperator."""

    AND = 0
    OR = 1

    @classmethod
    def parse(cls, v) -> "LogicalOp":
        if isinstance(v, LogicalOp):
            return v
        if isinstance(v, str):
            return cls[v.strip().upper()]
        return cls(int(v))


@dataclass(frozen=True)
class Filter:
    """Leaf predicate: ``index_name <op> value``."""

    index_name: str
    op: Op
    value: Union[str, int, float, bool]

    def __post_init__(self):
        object.__setattr__(self, "op", Op.parse(self.op))

    def to_dict(self) -> dict:
        return {
            "filter": {
                "index_name": self.index_name,
                "op": int(self.op),
                "value": self.value,
            }
        }


@dataclass(frozen=True)
class CompositeFilter:
    """AND/OR over sub-expressions (recursive)."""

    op: LogicalOp
    expressions: Sequence["FilterExpression"]

    def __post_init__(self):
        object.__setattr__(self, "op", LogicalOp.parse(self.op))
        object.__setattr__(self, "expressions", tuple(self.expressions))

    def to_dict(self) -> dict:
        return {
            "composite": {
                "op": int(self.op),
                "expressions": [e.to_dict() for e in self.expressions],
            }
        }


FilterExpression = Union[Filter, CompositeFilter]


def filter_from_dict(d: dict) -> FilterExpression:
    """Inverse of ``to_dict`` (wire/persistence format)."""
    if "filter" in d:
        f = d["filter"]
        return Filter(f["index_name"], Op.parse(f["op"]), f["value"])
    if "composite" in d:
        c = d["composite"]
        return CompositeFilter(
            LogicalOp.parse(c["op"]),
            [filter_from_dict(e) for e in c["expressions"]],
        )
    raise ValueError(f"not a filter expression: {d!r}")


def And(*expressions: FilterExpression) -> CompositeFilter:
    return CompositeFilter(LogicalOp.AND, expressions)


def Or(*expressions: FilterExpression) -> CompositeFilter:
    return CompositeFilter(LogicalOp.OR, expressions)
