"""Typed AST / object model for the SiddhiQL-compatible query language.

This is the TPU framework's analog of the reference's `siddhi-query-api`
module (reference: modules/siddhi-query-api/.../definition/*.java,
execution/query/Query.java, expression/*.java).  Unlike the reference's
mutable POJOs + fluent builder, the AST here is plain frozen dataclasses:
the compiler consumes it immutably and lowering is purely functional.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Union


# ---------------------------------------------------------------------------
# Attribute types (reference: query-api definition/Attribute.java:105)
# ---------------------------------------------------------------------------

class AttrType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    BOOL = "bool"
    OBJECT = "object"

    @property
    def is_numeric(self) -> bool:
        return self in (AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE)


@dataclass(frozen=True)
class Attribute:
    name: str
    type: AttrType


# ---------------------------------------------------------------------------
# Annotations  (reference: query-api annotation/Annotation.java)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Annotation:
    """``@name(key='value', 'indexed value', ...)`` — also nested annotations."""
    name: str                                   # lowercase, e.g. "app:name", "async"
    elements: tuple[tuple[Optional[str], str], ...] = ()   # (key or None, value)
    annotations: tuple["Annotation", ...] = ()  # nested (e.g. @map inside @source)

    def element(self, key: Optional[str] = None, default: Optional[str] = None) -> Optional[str]:
        for k, v in self.elements:
            if k == key or (key is None and k is None):
                return v
        if key is not None:
            # a lone positional value answers any key miss: @app:name('X')
            pos = self.positional()
            if len(pos) == 1:
                return pos[0]
        return default

    def positional(self) -> list[str]:
        return [v for k, v in self.elements if k is None]


def find_annotation(annotations, name: str) -> Optional[Annotation]:
    for a in annotations:
        if a.name.lower() == name.lower():
            return a
    return None


# ---------------------------------------------------------------------------
# Expressions (reference: query-api expression/**)
# ---------------------------------------------------------------------------

class Expression:
    """Marker base class."""
    __slots__ = ()


@dataclass(frozen=True)
class Constant(Expression):
    value: Any
    type: AttrType


@dataclass(frozen=True)
class TimeConstant(Expression):
    """A time literal like ``1 sec`` — value always milliseconds."""
    millis: int


@dataclass(frozen=True)
class Variable(Expression):
    """``price`` / ``StockStream.price`` / ``e1.price`` / ``e1[2].price``."""
    attribute: str
    stream_ref: Optional[str] = None     # stream id or pattern state ref (e1)
    index: Optional[Union[int, str]] = None  # e1[0].x, e1[last].x


class CompareOp(enum.Enum):
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="
    EQ = "=="
    NEQ = "!="


@dataclass(frozen=True)
class Compare(Expression):
    left: Expression
    op: CompareOp
    right: Expression


@dataclass(frozen=True)
class And(Expression):
    left: Expression
    right: Expression


@dataclass(frozen=True)
class Or(Expression):
    left: Expression
    right: Expression


@dataclass(frozen=True)
class Not(Expression):
    expr: Expression


@dataclass(frozen=True)
class IsNull(Expression):
    expr: Optional[Expression] = None
    stream_ref: Optional[str] = None     # `e1 is null` inside patterns
    index: Optional[Union[int, str]] = None


@dataclass(frozen=True)
class In(Expression):
    expr: Expression
    table_id: str


class MathOp(enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"


@dataclass(frozen=True)
class Math(Expression):
    left: Expression
    op: MathOp
    right: Expression


@dataclass(frozen=True)
class FunctionCall(Expression):
    """``ns:name(args...)`` — covers scalar functions and attribute aggregators."""
    name: str
    args: tuple[Expression, ...] = ()
    namespace: Optional[str] = None


# ---------------------------------------------------------------------------
# Stream handlers: filter / window / stream function
# ---------------------------------------------------------------------------

class StreamHandler:
    __slots__ = ()


@dataclass(frozen=True)
class Filter(StreamHandler):
    expr: Expression


@dataclass(frozen=True)
class WindowHandler(StreamHandler):
    name: str                              # "length", "time", "externalTimeBatch"...
    args: tuple[Expression, ...] = ()
    namespace: Optional[str] = None


@dataclass(frozen=True)
class StreamFunction(StreamHandler):
    name: str
    args: tuple[Expression, ...] = ()
    namespace: Optional[str] = None


# ---------------------------------------------------------------------------
# Input streams (reference: query-api execution/query/input/stream/*)
# ---------------------------------------------------------------------------

class InputStream:
    __slots__ = ()


@dataclass(frozen=True)
class SingleInputStream(InputStream):
    stream_id: str
    ref_id: Optional[str] = None          # `as X` alias / pattern event ref
    handlers: tuple[StreamHandler, ...] = ()
    is_inner: bool = False                # `#innerStream` inside partitions
    is_fault: bool = False                # `!faultStream`

    @property
    def alias(self) -> str:
        return self.ref_id or self.stream_id

    @property
    def window(self) -> Optional[WindowHandler]:
        for h in self.handlers:
            if isinstance(h, WindowHandler):
                return h
        return None

    @property
    def filters(self) -> tuple[Filter, ...]:
        return tuple(h for h in self.handlers if isinstance(h, Filter))


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"


@dataclass(frozen=True)
class JoinInputStream(InputStream):
    left: SingleInputStream
    right: SingleInputStream
    join_type: JoinType = JoinType.INNER
    on: Optional[Expression] = None
    within: Optional[Expression] = None           # aggregation join: within ...
    per: Optional[Expression] = None              # aggregation join: per ...
    trigger: str = "all"                          # "left"|"right"|"all" (unidirectional)


# --- pattern / sequence state elements (reference: execution/query/input/state/*)

class StateElement:
    __slots__ = ()


@dataclass(frozen=True)
class StreamStateElement(StateElement):
    stream: SingleInputStream              # carries ref (e1=) and filters
    within: Optional[TimeConstant] = None


@dataclass(frozen=True)
class AbsentStreamStateElement(StateElement):
    """``not Stream[filter] for 1 sec`` (waiting_time may be None when used
    with `and/or` against a present stream)."""
    stream: SingleInputStream
    waiting_time: Optional[TimeConstant] = None
    within: Optional[TimeConstant] = None


@dataclass(frozen=True)
class LogicalStateElement(StateElement):
    left: StateElement
    op: str                                # "and" | "or"
    right: StateElement
    within: Optional[TimeConstant] = None


@dataclass(frozen=True)
class CountStateElement(StateElement):
    stream: StreamStateElement
    min_count: int
    max_count: int                         # -1 == unbounded ("<2:>" etc.)
    within: Optional[TimeConstant] = None

    ANY = -1


@dataclass(frozen=True)
class NextStateElement(StateElement):
    state: StateElement
    next: StateElement
    within: Optional[TimeConstant] = None


@dataclass(frozen=True)
class EveryStateElement(StateElement):
    state: StateElement
    within: Optional[TimeConstant] = None


class StateType(enum.Enum):
    PATTERN = "pattern"    # skip-till-any-match (other events may interleave)
    SEQUENCE = "sequence"  # strict contiguity


@dataclass(frozen=True)
class StateInputStream(InputStream):
    type: StateType
    state: StateElement
    within: Optional[TimeConstant] = None


# ---------------------------------------------------------------------------
# Selector (reference: execution/query/selection/Selector.java)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OutputAttribute:
    expr: Expression
    rename: Optional[str] = None

    @property
    def name(self) -> str:
        if self.rename:
            return self.rename
        if isinstance(self.expr, Variable):
            return self.expr.attribute
        raise ValueError(f"output attribute needs 'as' rename: {self.expr}")


class OrderDir(enum.Enum):
    ASC = "asc"
    DESC = "desc"


@dataclass(frozen=True)
class OrderByAttribute:
    var: Variable
    order: OrderDir = OrderDir.ASC


@dataclass(frozen=True)
class Selector:
    select_all: bool = False
    attributes: tuple[OutputAttribute, ...] = ()
    group_by: tuple[Variable, ...] = ()
    having: Optional[Expression] = None
    order_by: tuple[OrderByAttribute, ...] = ()
    limit: Optional[int] = None
    offset: Optional[int] = None


# ---------------------------------------------------------------------------
# Output streams & rate (reference: execution/query/output/stream/*)
# ---------------------------------------------------------------------------

class OutputEventsFor(enum.Enum):
    CURRENT = "current"
    EXPIRED = "expired"
    ALL = "all"


class OutputStreamAction:
    __slots__ = ()


@dataclass(frozen=True)
class InsertInto(OutputStreamAction):
    target: str
    events_for: OutputEventsFor = OutputEventsFor.CURRENT
    is_fault: bool = False
    is_inner: bool = False


@dataclass(frozen=True)
class UpdateSetClause:
    attribute: Variable                    # table column
    value: Expression


@dataclass(frozen=True)
class DeleteFrom(OutputStreamAction):
    target: str
    on: Expression
    events_for: OutputEventsFor = OutputEventsFor.CURRENT


@dataclass(frozen=True)
class UpdateTable(OutputStreamAction):
    target: str
    on: Expression
    set_clauses: tuple[UpdateSetClause, ...] = ()
    events_for: OutputEventsFor = OutputEventsFor.CURRENT


@dataclass(frozen=True)
class UpdateOrInsertTable(OutputStreamAction):
    target: str
    on: Expression
    set_clauses: tuple[UpdateSetClause, ...] = ()
    events_for: OutputEventsFor = OutputEventsFor.CURRENT


@dataclass(frozen=True)
class ReturnAction(OutputStreamAction):
    """`return` — results delivered only to query callback."""
    events_for: OutputEventsFor = OutputEventsFor.CURRENT


class RateType(enum.Enum):
    ALL = "all"
    FIRST = "first"
    LAST = "last"


@dataclass(frozen=True)
class EventOutputRate:
    """``output [all|first|last] every N events``"""
    count: int
    type: RateType = RateType.ALL


@dataclass(frozen=True)
class TimeOutputRate:
    """``output [all|first|last] every 1 sec``"""
    millis: int
    type: RateType = RateType.ALL


@dataclass(frozen=True)
class SnapshotOutputRate:
    """``output snapshot every 1 sec``"""
    millis: int


OutputRate = Union[EventOutputRate, TimeOutputRate, SnapshotOutputRate, None]


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StreamDefinition:
    id: str
    attributes: tuple[Attribute, ...]
    annotations: tuple[Annotation, ...] = ()

    def attr_names(self) -> list[str]:
        return [a.name for a in self.attributes]


@dataclass(frozen=True)
class TableDefinition:
    id: str
    attributes: tuple[Attribute, ...]
    annotations: tuple[Annotation, ...] = ()

    def primary_keys(self) -> list[str]:
        a = find_annotation(self.annotations, "primarykey")
        return a.positional() if a else []

    def indexes(self) -> list[str]:
        a = find_annotation(self.annotations, "index")
        return a.positional() if a else []


@dataclass(frozen=True)
class WindowDefinition:
    """``define window W (a int) length(5) output all events``"""
    id: str
    attributes: tuple[Attribute, ...]
    window: WindowHandler
    output_events: OutputEventsFor = OutputEventsFor.ALL
    annotations: tuple[Annotation, ...] = ()


@dataclass(frozen=True)
class TriggerDefinition:
    """``define trigger T at every 5 sec | at 'cron expr' | at 'start'``"""
    id: str
    at_every_millis: Optional[int] = None
    at_cron: Optional[str] = None
    at_start: bool = False
    annotations: tuple[Annotation, ...] = ()


@dataclass(frozen=True)
class FunctionDefinition:
    """``define function f[lang] return type { body }`` (script functions)."""
    id: str
    language: str
    return_type: AttrType
    body: str
    annotations: tuple[Annotation, ...] = ()


class Duration(enum.Enum):
    SECONDS = "sec"
    MINUTES = "min"
    HOURS = "hour"
    DAYS = "day"
    WEEKS = "week"
    MONTHS = "month"
    YEARS = "year"

    @property
    def approx_millis(self) -> int:
        return _DURATION_MS[self]


_DURATION_MS = {
    Duration.SECONDS: 1_000,
    Duration.MINUTES: 60_000,
    Duration.HOURS: 3_600_000,
    Duration.DAYS: 86_400_000,
    Duration.WEEKS: 604_800_000,
    Duration.MONTHS: 2_592_000_000,   # 30 days (bucketing uses calendar)
    Duration.YEARS: 31_536_000_000,   # 365 days
}

DURATION_ORDER = [Duration.SECONDS, Duration.MINUTES, Duration.HOURS,
                  Duration.DAYS, Duration.WEEKS, Duration.MONTHS, Duration.YEARS]


@dataclass(frozen=True)
class AggregationDefinition:
    """``define aggregation A from S select ... group by ... aggregate by ts
    every sec...year`` (reference: AggregationDefinition.java + AggregationParser)."""
    id: str
    input: SingleInputStream
    selector: Selector
    by_attribute: Optional[Variable]      # aggregate by <ts attr>; None -> arrival time
    durations: tuple[Duration, ...] = ()
    annotations: tuple[Annotation, ...] = ()


Definition = Union[StreamDefinition, TableDefinition, WindowDefinition,
                   TriggerDefinition, FunctionDefinition, AggregationDefinition]


# ---------------------------------------------------------------------------
# Execution elements
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Query:
    input: InputStream
    selector: Selector
    output: OutputStreamAction
    rate: OutputRate = None
    annotations: tuple[Annotation, ...] = ()

    def name(self, default: str) -> str:
        a = find_annotation(self.annotations, "info")
        if a:
            v = a.element("name")
            if v:
                return v
        return default


@dataclass(frozen=True)
class RangePartitionCase:
    condition: Expression
    key: str                                # 'label' for matching events


@dataclass(frozen=True)
class PartitionKey:
    stream_id: str
    expr: Optional[Expression] = None        # value partition: `symbol of S`
    ranges: tuple[RangePartitionCase, ...] = ()  # range partition


@dataclass(frozen=True)
class Partition:
    keys: tuple[PartitionKey, ...]
    queries: tuple[Query, ...]
    annotations: tuple[Annotation, ...] = ()


ExecutionElement = Union[Query, Partition]


# ---------------------------------------------------------------------------
# Store (on-demand) queries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StoreQuery:
    """``from Table[on cond] select ...`` / update/delete store queries."""
    input: InputStream
    selector: Selector
    action: Optional[OutputStreamAction] = None   # None == find/select
    within: Optional[Expression] = None           # aggregation store query
    per: Optional[Expression] = None


# ---------------------------------------------------------------------------
# The app
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SiddhiApp:
    annotations: tuple[Annotation, ...] = ()
    stream_definitions: dict = field(default_factory=dict)
    table_definitions: dict = field(default_factory=dict)
    window_definitions: dict = field(default_factory=dict)
    trigger_definitions: dict = field(default_factory=dict)
    function_definitions: dict = field(default_factory=dict)
    aggregation_definitions: dict = field(default_factory=dict)
    execution_elements: tuple[ExecutionElement, ...] = ()

    @property
    def name(self) -> str:
        a = find_annotation(self.annotations, "app:name")
        if a:
            v = a.element(None) or a.element("name")
            if v:
                return v
        return "SiddhiApp"

    def annotation(self, name: str) -> Optional[Annotation]:
        return find_annotation(self.annotations, name)
