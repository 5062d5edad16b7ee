"""Spark-SQL-shaped type objects and their Arrow mapping.

Copy of ``spark_rapids_ml_tpu/localspark/types.py``: the port's local Spark
engine keeps its own, so that it imports nothing of the JAX package.

Mirrors the ``pyspark.sql.types`` subset the Spark-facing estimators build
schemas with, so the same estimator code drives pyspark and localspark
DataFrames. Each type knows its Arrow equivalent — the contract at the
``mapInArrow`` boundary where Spark maps ArrayType(DoubleType) to
``list_(float64())`` etc.
"""

from __future__ import annotations

import pyarrow as pa


class DataType:
    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def to_arrow(self) -> pa.DataType:
        raise NotImplementedError

    def simpleString(self) -> str:
        return type(self).__name__.replace("Type", "").lower()


class DoubleType(DataType):
    def to_arrow(self) -> pa.DataType:
        return pa.float64()


class FloatType(DataType):
    def to_arrow(self) -> pa.DataType:
        return pa.float32()


class LongType(DataType):
    def to_arrow(self) -> pa.DataType:
        return pa.int64()

    def simpleString(self) -> str:
        return "bigint"


class IntegerType(DataType):
    def to_arrow(self) -> pa.DataType:
        return pa.int32()

    def simpleString(self) -> str:
        return "int"


class StringType(DataType):
    def to_arrow(self) -> pa.DataType:
        return pa.string()


class BooleanType(DataType):
    def to_arrow(self) -> pa.DataType:
        return pa.bool_()


class ArrayType(DataType):
    def __init__(self, elementType: DataType, containsNull: bool = True):
        self.elementType = elementType
        self.containsNull = containsNull

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ArrayType) and self.elementType == other.elementType
        )

    def __hash__(self) -> int:
        return hash(("ArrayType", self.elementType))

    def __repr__(self) -> str:
        return f"ArrayType({self.elementType!r})"

    def to_arrow(self) -> pa.DataType:
        return pa.list_(self.elementType.to_arrow())

    def simpleString(self) -> str:
        return f"array<{self.elementType.simpleString()}>"


class StructField:
    def __init__(self, name: str, dataType: DataType, nullable: bool = True):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, StructField)
            and self.name == other.name
            and self.dataType == other.dataType
        )

    def __repr__(self) -> str:
        return f"StructField({self.name!r}, {self.dataType!r})"

    def to_arrow(self) -> pa.Field:
        return pa.field(self.name, self.dataType.to_arrow(), nullable=self.nullable)


class StructType(DataType):
    def __init__(self, fields: list[StructField] | None = None):
        self.fields = list(fields or [])

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def add(self, name: str, dataType: DataType, nullable: bool = True) -> "StructType":
        self.fields.append(StructField(name, dataType, nullable))
        return self

    def __getitem__(self, key):
        if isinstance(key, str):
            for f in self.fields:
                if f.name == key:
                    return f
            raise KeyError(key)
        return self.fields[key]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __eq__(self, other) -> bool:
        return isinstance(other, StructType) and self.fields == other.fields

    def __repr__(self) -> str:
        return f"StructType({self.fields!r})"

    def to_arrow(self) -> pa.Schema:
        return pa.schema([f.to_arrow() for f in self.fields])


_ARROW_TO_SPARK = [
    (pa.types.is_float64, DoubleType),
    (pa.types.is_float32, FloatType),
    (pa.types.is_int64, LongType),
    (pa.types.is_int32, IntegerType),
    (pa.types.is_string, StringType),
    (pa.types.is_boolean, BooleanType),
]


def from_arrow_type(t: pa.DataType) -> DataType:
    if pa.types.is_list(t) or pa.types.is_fixed_size_list(t) or pa.types.is_large_list(t):
        return ArrayType(from_arrow_type(t.value_type))
    for pred, cls in _ARROW_TO_SPARK:
        if pred(t):
            return cls()
    raise TypeError(f"unsupported Arrow type for localspark: {t}")


def from_arrow_schema(schema: pa.Schema) -> StructType:
    return StructType(
        [StructField(f.name, from_arrow_type(f.type), f.nullable) for f in schema]
    )
