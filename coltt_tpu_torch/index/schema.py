"""Collection schema + payload analyzer.

Reference parity: ``edge/edge_metadata.go:22-37`` (``Metadata{Dim, Distance,
Quantization, IndexType map[string]IndexFeature, Versioning}``) and the
analyzers ``edge/edge_analyzer.go:28-148`` (standardAnalyzer: validates
insert payloads against the schema, enforces the string primary key and
EnableNull defaults; dropKeyAnalyzer for deletes). The experimental engine
adds Vector-typed fields (IndexType_Vector=4,
idl/proto/v3/experimental.proto).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization


class FieldType(enum.IntEnum):
    """Matches proto IndexType numbering (edge.proto / experimental.proto)."""

    STRING = 0
    INTEGER = 1
    FLOAT = 2
    BOOLEAN = 3
    VECTOR = 4  # experimental (multi-vector) only

    @classmethod
    def parse(cls, v) -> "FieldType":
        if isinstance(v, FieldType):
            return v
        if isinstance(v, str):
            aliases = {"STR": "STRING", "INT": "INTEGER", "BOOL": "BOOLEAN"}
            key = aliases.get(v.strip().upper(), v.strip().upper())
            return cls[key]
        return cls(int(v))


_PY_TYPES = {
    FieldType.STRING: (str,),
    FieldType.INTEGER: (int,),
    FieldType.FLOAT: (int, float),
    FieldType.BOOLEAN: (bool,),
}

_NULL_DEFAULTS = {
    FieldType.STRING: "",
    FieldType.INTEGER: 0,
    FieldType.FLOAT: 0.0,
    FieldType.BOOLEAN: False,
}


class SchemaError(ValueError):
    pass


@dataclass(frozen=True)
class FieldSchema:
    name: str
    type: FieldType
    enable_null: bool = False
    primary_key: bool = False

    def __post_init__(self):
        object.__setattr__(self, "type", FieldType.parse(self.type))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "type": int(self.type),
            "enable_null": self.enable_null,
            "primary_key": self.primary_key,
        }


@dataclass(frozen=True)
class CollectionSchema:
    """Full collection definition (proto message Collection, edge.proto)."""

    name: str
    dim: int
    metric: Metric = Metric.COSINE
    quantization: Quantization = Quantization.NONE
    fields: Tuple[FieldSchema, ...] = field(default_factory=tuple)
    versioning: bool = False

    def __post_init__(self):
        object.__setattr__(self, "metric", Metric.parse(self.metric))
        object.__setattr__(self, "quantization", Quantization.parse(self.quantization))
        object.__setattr__(self, "fields", tuple(self.fields))
        pks = [f for f in self.fields if f.primary_key]
        if len(pks) > 1:
            raise SchemaError(f"collection {self.name!r}: multiple primary keys")
        if pks and pks[0].type != FieldType.STRING:
            # primary-key-must-be-string, edge/edge_analyzer.go:28-98
            raise SchemaError(
                f"collection {self.name!r}: primary key {pks[0].name!r} must be string"
            )

    # -- accessors ---------------------------------------------------------
    @property
    def primary_key(self) -> Optional[str]:
        for f in self.fields:
            if f.primary_key:
                return f.name
        return None

    @property
    def vector_fields(self) -> List[str]:
        return [f.name for f in self.fields if f.type == FieldType.VECTOR]

    def field_map(self) -> Dict[str, FieldSchema]:
        return {f.name: f for f in self.fields}

    # -- analyzers ---------------------------------------------------------
    def analyze_insert(self, metadata: Dict[str, Any]) -> Dict[str, Any]:
        """Validate + normalize an insert/upsert payload (standardAnalyzer
        parity). Returns the normalized metadata; raises SchemaError."""
        if not isinstance(metadata, dict):
            raise SchemaError("metadata must be an object")
        fmap = self.field_map()
        out: Dict[str, Any] = {}
        for name, fs in fmap.items():
            if fs.type == FieldType.VECTOR:
                continue  # vector fields validated by the multi-vector store
            if name not in metadata or metadata[name] is None:
                if fs.primary_key:
                    raise SchemaError(f"missing primary key field {name!r}")
                if not fs.enable_null:
                    raise SchemaError(f"field {name!r} is required (enable_null=false)")
                out[name] = _NULL_DEFAULTS[fs.type]
                continue
            v = metadata[name]
            ok_types = _PY_TYPES[fs.type]
            if fs.type != FieldType.BOOLEAN and isinstance(v, bool):
                raise SchemaError(f"field {name!r}: expected {fs.type.name}, got bool")
            if (
                fs.type == FieldType.INTEGER
                and isinstance(v, float)
                and v.is_integer()
            ):
                # protobuf Struct carries all numbers as doubles; whole
                # doubles are valid integers at the wire boundary
                v = int(v)
            if not isinstance(v, ok_types):
                raise SchemaError(
                    f"field {name!r}: expected {fs.type.name}, got {type(v).__name__}"
                )
            if fs.type == FieldType.FLOAT:
                v = float(v)
            out[name] = v
        extra = set(metadata) - set(fmap)
        if extra:
            raise SchemaError(f"unknown metadata fields: {sorted(extra)}")
        return out

    def analyze_drop_key(self, metadata: Dict[str, Any]) -> str:
        """Extract + validate the primary key from a delete payload
        (dropKeyAnalyzer parity, edge/edge_analyzer.go:110-148)."""
        pk = self.primary_key
        if pk is None:
            raise SchemaError(f"collection {self.name!r} has no primary key")
        if pk not in metadata or metadata[pk] is None:
            raise SchemaError(f"delete payload missing primary key {pk!r}")
        v = metadata[pk]
        if not isinstance(v, str):
            raise SchemaError(f"primary key {pk!r} must be a string")
        return v

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dim": self.dim,
            "metric": int(self.metric),
            "quantization": int(self.quantization),
            "fields": [f.to_dict() for f in self.fields],
            "versioning": self.versioning,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CollectionSchema":
        return cls(
            name=d["name"],
            dim=int(d["dim"]),
            metric=Metric.parse(d.get("metric", 0)),
            quantization=Quantization.parse(d.get("quantization", 0)),
            fields=tuple(
                FieldSchema(
                    f["name"],
                    FieldType.parse(f["type"]),
                    bool(f.get("enable_null", False)),
                    bool(f.get("primary_key", False)),
                )
                for f in d.get("fields", [])
            ),
            versioning=bool(d.get("versioning", False)),
        )
