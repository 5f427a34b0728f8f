"""proto <-> engine-object marshaling.

The role of the reference's per-RPC marshal code in the service layers
(root_layer/*/... building engine inputs from proto and back) and
queryExprAnalyzer (edge/edge_analyzer.go:150-192) converting proto filter
trees into engine filter expressions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from google.protobuf import struct_pb2

import common_pb2  # noqa: E402  (gen dir on sys.path via coltt_tpu_torch.api)

from coltt_tpu_torch.engine.errors import EngineError
from coltt_tpu_torch.index.filter import (
    CompositeFilter,
    Filter,
    FilterExpression,
    LogicalOp,
    Op,
)
from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization


# -- Struct <-> dict ---------------------------------------------------------

def struct_to_dict(s: struct_pb2.Struct) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in s.fields.items():
        kind = value.WhichOneof("kind")
        if kind == "string_value":
            out[key] = value.string_value
        elif kind == "number_value":
            # Struct carries every number as a double; surface whole values
            # as ints (schema analyzers re-coerce FLOAT fields to float)
            n = value.number_value
            out[key] = int(n) if n.is_integer() else n
        elif kind == "bool_value":
            out[key] = value.bool_value
        elif kind == "null_value":
            out[key] = None
        else:
            raise EngineError(f"metadata field {key!r}: unsupported Struct kind {kind}")
    return out


def dict_to_struct(d: Dict[str, Any]) -> struct_pb2.Struct:
    s = struct_pb2.Struct()
    for key, value in (d or {}).items():
        if value is None:
            s.fields[key].null_value = 0
        elif isinstance(value, bool):
            s.fields[key].bool_value = value
        elif isinstance(value, (int, float)):
            s.fields[key].number_value = float(value)
        else:
            s.fields[key].string_value = str(value)
    return s


# -- filter expression tree ---------------------------------------------------

def filter_from_proto(expr: common_pb2.FilterExpression) -> Optional[FilterExpression]:
    which = expr.WhichOneof("expr")
    if which is None:
        return None
    if which == "filter":
        f = expr.filter
        vkind = f.WhichOneof("value")
        if vkind is None:
            raise EngineError(f"filter on {f.index_name!r} has no value")
        value = getattr(f, vkind)
        return Filter(f.index_name, Op(f.op), value)
    comp = expr.composite
    subs = [filter_from_proto(e) for e in comp.expressions]
    subs = [s for s in subs if s is not None]
    if not subs:
        return None
    return CompositeFilter(LogicalOp(comp.op), subs)


def filter_to_proto(expr: FilterExpression) -> common_pb2.FilterExpression:
    out = common_pb2.FilterExpression()
    if isinstance(expr, Filter):
        out.filter.index_name = expr.index_name
        out.filter.op = int(expr.op)
        v = expr.value
        if isinstance(v, bool):
            out.filter.bool_val = v
        elif isinstance(v, int):
            out.filter.int_val = v
        elif isinstance(v, float):
            out.filter.float_val = v
        else:
            out.filter.string_val = str(v)
    else:
        out.composite.op = int(expr.op)
        out.composite.expressions.extend(
            filter_to_proto(e) for e in expr.expressions
        )
    return out


# -- schema <-> Collection messages ----------------------------------------------

def schema_from_collection_msg(msg) -> CollectionSchema:
    """Works for both edge.Collection and experimental.Collection."""
    fields = [
        FieldSchema(
            f.index_name,
            FieldType(int(f.index_type)),
            bool(getattr(f, "enable_null", False)),
            bool(getattr(f, "primary_key", False)),
        )
        for f in msg.index
    ]
    return CollectionSchema(
        name=msg.collection_name,
        dim=int(msg.dim),
        metric=Metric(int(msg.distance)),
        quantization=Quantization(int(msg.quantization)),
        fields=fields,
        versioning=bool(msg.versioning),
    )


def schema_to_collection_msg(schema: CollectionSchema, msg_cls, field_cls):
    msg = msg_cls(
        collection_name=schema.name,
        distance=int(schema.metric),
        quantization=int(schema.quantization),
        dim=schema.dim,
        versioning=schema.versioning,
    )
    for f in schema.fields:
        kw = dict(index_name=f.name, index_type=int(f.type), enable_null=f.enable_null)
        if "primary_key" in field_cls.DESCRIPTOR.fields_by_name:
            kw["primary_key"] = f.primary_key
        msg.index.append(field_cls(**kw))
    return msg


def error_to_proto(e: Exception) -> common_pb2.Error:
    if isinstance(e, EngineError):
        return common_pb2.Error(error_message=e.message, error_code=int(e.code))
    return common_pb2.Error(
        error_message=f"{type(e).__name__}: {e}",
        error_code=common_pb2.INTERNAL_FUNC_ERROR,
    )
