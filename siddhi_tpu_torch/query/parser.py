"""Recursive-descent parser: SiddhiQL text -> typed AST.

The TPU framework's analog of the reference's `siddhi-query-compiler`
(reference: SiddhiQL.g4 grammar — app structure :34-45, patterns :200-291,
sequences :291-340, query sections :360-415 — plus the 3,073-line
SiddhiQLBaseVisitorImpl.java AST builder).  One pass, no generated code.

Entry points mirror `SiddhiCompiler` (reference:
modules/siddhi-query-compiler/.../SiddhiCompiler.java:57-192):
  parse(text)              -> ast.SiddhiApp
  parse_query(text)        -> ast.Query
  parse_store_query(text)  -> ast.StoreQuery
  parse_expression(text)   -> ast.Expression
"""
from __future__ import annotations

from typing import Optional, Union

from . import ast
from .ast import AttrType, CompareOp, MathOp
from .lexer import Token, TokenType, tokenize


class ParseError(Exception):
    def __init__(self, msg: str, token: Optional[Token] = None):
        if token is not None:
            msg = f"{msg} (at line {token.line}:{token.col}, near {token.value!r})"
        super().__init__(msg)


_TIME_UNITS_MS = {
    "millisecond": 1, "milliseconds": 1, "millisec": 1, "ms": 1,
    "second": 1000, "seconds": 1000, "sec": 1000,
    "minute": 60_000, "minutes": 60_000, "min": 60_000,
    "hour": 3_600_000, "hours": 3_600_000,
    "day": 86_400_000, "days": 86_400_000,
    "week": 604_800_000, "weeks": 604_800_000,
    "month": 2_592_000_000, "months": 2_592_000_000,
    "year": 31_536_000_000, "years": 31_536_000_000,
}

_DURATIONS = {
    "sec": ast.Duration.SECONDS, "second": ast.Duration.SECONDS, "seconds": ast.Duration.SECONDS,
    "min": ast.Duration.MINUTES, "minute": ast.Duration.MINUTES, "minutes": ast.Duration.MINUTES,
    "hour": ast.Duration.HOURS, "hours": ast.Duration.HOURS,
    "day": ast.Duration.DAYS, "days": ast.Duration.DAYS,
    "week": ast.Duration.WEEKS, "weeks": ast.Duration.WEEKS,
    "month": ast.Duration.MONTHS, "months": ast.Duration.MONTHS,
    "year": ast.Duration.YEARS, "years": ast.Duration.YEARS,
}

_ATTR_TYPES = {
    "string": AttrType.STRING, "int": AttrType.INT, "long": AttrType.LONG,
    "float": AttrType.FLOAT, "double": AttrType.DOUBLE, "bool": AttrType.BOOL,
    "object": AttrType.OBJECT,
}

class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.type != TokenType.EOF:
            self.i += 1
        return t

    def at_kw(self, *kws: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.type == TokenType.IDENT and t.lower() in kws

    def at_op(self, *ops: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.type == TokenType.OP and t.value in ops

    def eat_kw(self, *kws: str) -> Token:
        if not self.at_kw(*kws):
            raise ParseError(f"expected {'/'.join(kws)}", self.peek())
        return self.next()

    def eat_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise ParseError(f"expected {op!r}", self.peek())
        return self.next()

    def try_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def try_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def ident(self) -> str:
        t = self.peek()
        if t.type != TokenType.IDENT:
            raise ParseError("expected identifier", t)
        self.next()
        return t.value

    # -- app ----------------------------------------------------------------

    def parse_app(self) -> ast.SiddhiApp:
        app_annotations: list[ast.Annotation] = []
        streams: dict = {}
        tables: dict = {}
        windows: dict = {}
        triggers: dict = {}
        functions: dict = {}
        aggregations: dict = {}
        elements: list = []

        while self.peek().type != TokenType.EOF:
            annotations = self.parse_annotations()
            # @app:* annotations always belong to the app, wherever they appear
            app_annotations.extend(a for a in annotations if a.name.startswith("app:"))
            annotations = [a for a in annotations if not a.name.startswith("app:")]
            t = self.peek()
            if t.type == TokenType.EOF:
                app_annotations.extend(annotations)
                break
            if self.at_kw("define"):
                d = self.parse_definition(tuple(annotations))
                if isinstance(d, ast.StreamDefinition):
                    streams[d.id] = d
                elif isinstance(d, ast.TableDefinition):
                    tables[d.id] = d
                elif isinstance(d, ast.WindowDefinition):
                    windows[d.id] = d
                elif isinstance(d, ast.TriggerDefinition):
                    triggers[d.id] = d
                    # triggers implicitly define a stream (triggered_time long)
                    streams.setdefault(d.id, ast.StreamDefinition(
                        d.id, (ast.Attribute("triggered_time", AttrType.LONG),)))
                elif isinstance(d, ast.FunctionDefinition):
                    functions[d.id] = d
                elif isinstance(d, ast.AggregationDefinition):
                    aggregations[d.id] = d
            elif self.at_kw("partition"):
                elements.append(self.parse_partition(tuple(annotations)))
            elif self.at_kw("from"):
                elements.append(self.parse_query_body(tuple(annotations)))
            else:
                # bare app-level annotations appear before any element
                if annotations:
                    app_annotations.extend(annotations)
                    continue
                raise ParseError("expected define/partition/from", t)
            self.try_op(";")

        # split app-level annotations: those that came before the first element
        # but apply to the app (@app:*) vs stray ones.
        return ast.SiddhiApp(
            annotations=tuple(app_annotations),
            stream_definitions=streams,
            table_definitions=tables,
            window_definitions=windows,
            trigger_definitions=triggers,
            function_definitions=functions,
            aggregation_definitions=aggregations,
            execution_elements=tuple(elements),
        )

    def parse_annotations(self) -> list[ast.Annotation]:
        """Annotations preceding an element; @app:* are collected too.

        A trailing annotation list followed by `define`/`from`/`partition`
        belongs to that element; `@app:...` ones belong to the app but we
        return them all — parse_app sorts out placement.
        """
        anns = []
        while self.at_op("@"):
            anns.append(self.parse_annotation())
        # @app:xxx annotations apply to the app; return all, caller decides
        return anns

    def parse_annotation(self) -> ast.Annotation:
        self.eat_op("@")
        name = self.ident()
        if self.try_op(":"):
            name = f"{name}:{self.ident()}"
        elements: list = []
        nested: list = []
        if self.try_op("("):
            if not self.at_op(")"):
                while True:
                    if self.at_op("@"):
                        nested.append(self.parse_annotation())
                    else:
                        t = self.peek()
                        if t.type == TokenType.IDENT and (
                                self.at_op("=", ahead=1)
                                or self.at_op(".", ahead=1)):
                            # dotted keys: @app:async(batch.size.max='4')
                            key = self.ident()
                            while self.try_op("."):
                                key += "." + self.ident()
                            self.eat_op("=")
                            elements.append((key, self._annotation_value()))
                        else:
                            elements.append((None, self._annotation_value()))
                    if not self.try_op(","):
                        break
            self.eat_op(")")
        return ast.Annotation(name.lower(), tuple(elements), tuple(nested))

    def _annotation_value(self) -> str:
        t = self.next()
        if t.type in (TokenType.STRING, TokenType.IDENT, TokenType.INT,
                      TokenType.LONG, TokenType.DOUBLE, TokenType.FLOAT):
            return t.value
        if t.type == TokenType.OP and t.value == "-":
            n = self.next()
            return "-" + n.value
        raise ParseError("expected annotation value", t)

    # -- definitions --------------------------------------------------------

    def parse_definition(self, annotations) -> ast.Definition:
        self.eat_kw("define")
        kind = self.ident().lower()
        if kind == "stream":
            name = self.ident()
            attrs = self.parse_attr_list()
            return ast.StreamDefinition(name, attrs, annotations)
        if kind == "table":
            name = self.ident()
            attrs = self.parse_attr_list()
            return ast.TableDefinition(name, attrs, annotations)
        if kind == "window":
            name = self.ident()
            attrs = self.parse_attr_list()
            # window spec: `length(5)` or `time(1 sec)` — optionally ns:name
            wname = self.ident()
            ns = None
            if self.try_op(":"):
                ns, wname = wname, self.ident()
            args = self.parse_call_args()
            out = ast.OutputEventsFor.ALL
            if self.try_kw("output"):
                out = self.parse_events_for()
            return ast.WindowDefinition(name, attrs, ast.WindowHandler(wname, args, ns),
                                        out, annotations)
        if kind == "trigger":
            name = self.ident()
            self.eat_kw("at")
            if self.try_kw("every"):
                millis = self.parse_time_value()
                return ast.TriggerDefinition(name, at_every_millis=millis,
                                             annotations=annotations)
            t = self.next()
            if t.type != TokenType.STRING:
                raise ParseError("expected 'start' or cron string after at", t)
            if t.value == "start":
                return ast.TriggerDefinition(name, at_start=True, annotations=annotations)
            return ast.TriggerDefinition(name, at_cron=t.value, annotations=annotations)
        if kind == "function":
            name = self.ident()
            self.eat_op("[")
            lang = self.ident()
            self.eat_op("]")
            self.eat_kw("return")
            rt = self._attr_type(self.ident())
            body = self._raw_braced_block()
            return ast.FunctionDefinition(name, lang, rt, body, annotations)
        if kind == "aggregation":
            return self.parse_aggregation_def(annotations)
        raise ParseError(f"unknown definition kind {kind!r}", self.peek())

    def _attr_type(self, name: str) -> AttrType:
        try:
            return _ATTR_TYPES[name.lower()]
        except KeyError:
            raise ParseError(f"unknown attribute type {name!r}", self.peek()) from None

    def parse_attr_list(self) -> tuple[ast.Attribute, ...]:
        self.eat_op("(")
        attrs = []
        while True:
            aname = self.ident()
            attrs.append(ast.Attribute(aname, self._attr_type(self.ident())))
            if not self.try_op(","):
                break
        self.eat_op(")")
        return tuple(attrs)

    def _raw_braced_block(self) -> str:
        start_tok = self.eat_op("{")
        # raw scan in source text from this position, balancing braces
        depth = 1
        j = start_tok.pos + 1
        while j < len(self.text) and depth:
            if self.text[j] == "{":
                depth += 1
            elif self.text[j] == "}":
                depth -= 1
            j += 1
        if depth:
            raise ParseError("unterminated { } block", start_tok)
        body = self.text[start_tok.pos + 1:j - 1]
        # resync token stream past j
        while self.peek().type != TokenType.EOF and self.peek().pos < j:
            self.next()
        return body

    def parse_aggregation_def(self, annotations) -> ast.AggregationDefinition:
        name = self.ident()
        self.eat_kw("from")
        inp = self.parse_single_input_stream()
        selector = self.parse_selector_block()
        by = None
        if self.try_kw("aggregate"):
            if self.try_kw("by"):
                by = self._parse_variable_ref()
            self.eat_kw("every")
        else:
            self.eat_kw("every")
        durations = [self.parse_duration()]
        if self.at_op("."):
            # range: `sec ... year`
            self.eat_op(".")
            self.eat_op(".")
            self.eat_op(".")
            last = self.parse_duration()
            o = ast.DURATION_ORDER
            durations = o[o.index(durations[0]): o.index(last) + 1]
        else:
            while self.try_op(","):
                durations.append(self.parse_duration())
        return ast.AggregationDefinition(name, inp, selector, by,
                                         tuple(durations), annotations)

    def parse_duration(self) -> ast.Duration:
        t = self.ident().lower()
        if t not in _DURATIONS:
            raise ParseError(f"unknown duration {t!r}", self.peek())
        return _DURATIONS[t]

    # -- queries ------------------------------------------------------------

    def parse_query_body(self, annotations) -> ast.Query:
        self.eat_kw("from")
        input_stream = self.parse_input_stream()
        selector = self.parse_selector_block()
        rate = self.parse_output_rate()
        output = self.parse_output_action()
        return ast.Query(input_stream, selector, output, rate, annotations)

    # -- input streams ------------------------------------------------------

    def parse_input_stream(self) -> ast.InputStream:
        # Decide: pattern/sequence vs join vs single.
        # Patterns start with `every`, `not`, `(`, or `ref=`; sequences are
        # pattern-like but use ',' chaining.  A plain stream id followed by
        # `join`/`left`/`right`/`full`/`inner`/`unidirectional` is a join.
        if (self.at_kw("every", "not")
                or self.at_op("(")
                or (self.peek().type == TokenType.IDENT and self.at_op("=", ahead=1))):
            return self.parse_state_stream()
        save = self.i
        first = self.parse_single_input_stream()
        if self.at_kw("join", "left", "right", "full", "inner", "unidirectional"):
            return self.parse_join_tail(first)
        if self.at_op("->") or self.at_op(","):
            # pattern/sequence whose first element had no ref (rare but legal)
            self.i = save
            return self.parse_state_stream()
        return first

    def parse_single_input_stream(self) -> ast.SingleInputStream:
        is_inner = bool(self.try_op("#"))
        is_fault = bool(self.try_op("!"))
        sid = self.ident()
        handlers: list[ast.StreamHandler] = []
        handlers.extend(self.parse_stream_handlers())
        ref = None
        if self.try_kw("as"):
            ref = self.ident()
        # `unidirectional` handled by join parser
        return ast.SingleInputStream(sid, ref, tuple(handlers), is_inner, is_fault)

    def parse_stream_handlers(self) -> list[ast.StreamHandler]:
        handlers: list[ast.StreamHandler] = []
        while True:
            if self.at_op("["):
                self.eat_op("[")
                handlers.append(ast.Filter(self.parse_expression()))
                self.eat_op("]")
            elif self.at_op("#"):
                self.eat_op("#")
                name = self.ident()
                ns = None
                if self.try_op(":"):
                    ns, name = name, self.ident()
                if ns is None and name.lower() == "window":
                    self.eat_op(".")
                    wname = self.ident()
                    wns = None
                    if self.try_op(":"):
                        wns, wname = wname, self.ident()
                    args = self.parse_call_args()
                    handlers.append(ast.WindowHandler(wname, args, wns))
                else:
                    args = self.parse_call_args()
                    handlers.append(ast.StreamFunction(name, args, ns))
            else:
                return handlers

    def parse_call_args(self) -> tuple[ast.Expression, ...]:
        if not self.try_op("("):
            return ()
        args = []
        if not self.at_op(")"):
            while True:
                args.append(self.parse_expression())
                if not self.try_op(","):
                    break
        self.eat_op(")")
        return tuple(args)

    # -- joins ---------------------------------------------------------------

    def parse_join_tail(self, left: ast.SingleInputStream) -> ast.JoinInputStream:
        trigger = "all"
        if self.try_kw("unidirectional"):
            trigger = "left"
        jt = ast.JoinType.INNER
        if self.try_kw("left"):
            self.eat_kw("outer")
            self.eat_kw("join")
            jt = ast.JoinType.LEFT_OUTER
        elif self.try_kw("right"):
            self.eat_kw("outer")
            self.eat_kw("join")
            jt = ast.JoinType.RIGHT_OUTER
        elif self.try_kw("full"):
            self.eat_kw("outer")
            self.eat_kw("join")
            jt = ast.JoinType.FULL_OUTER
        elif self.try_kw("inner"):
            self.eat_kw("join")
        else:
            self.eat_kw("join")
        right = self.parse_single_input_stream()
        if self.try_kw("unidirectional"):
            trigger = "right" if trigger == "all" else trigger
        on = None
        if self.try_kw("on"):
            on = self.parse_expression()
        within = None
        per = None
        if self.try_kw("within"):
            within = self.parse_within_value()
        if self.try_kw("per"):
            per = self.parse_expression()
        return ast.JoinInputStream(left, right, jt, on, within, per, trigger)

    def parse_within_value(self):
        # aggregation-join within accepts expressions (timestamps / strings),
        # possibly `within a, b`
        first = self._time_or_expr()
        if self.try_op(","):
            second = self._time_or_expr()
            return ast.FunctionCall("withinRange", (first, second))
        return first

    def _time_or_expr(self):
        if self.peek().type in (TokenType.INT, TokenType.LONG) and \
                self.peek(1).type == TokenType.IDENT and self.peek(1).lower() in _TIME_UNITS_MS:
            return ast.TimeConstant(self.parse_time_value())
        return self.parse_expression()

    # -- patterns / sequences -----------------------------------------------

    def parse_state_stream(self) -> ast.StateInputStream:
        elem, is_seq = self.parse_state_chain()
        within = None
        if self.try_kw("within"):
            within = ast.TimeConstant(self.parse_time_value())
        st = ast.StateType.SEQUENCE if is_seq else ast.StateType.PATTERN
        return ast.StateInputStream(st, elem, within)

    def parse_state_chain(self) -> tuple[ast.StateElement, bool]:
        """Parse `a -> b -> c` or `a, b, c`; returns (element, is_sequence)."""
        first = self.parse_state_unit()
        is_seq = False
        elems = [first]
        while True:
            if self.try_op("->"):
                elems.append(self.parse_state_unit())
            elif self.at_op(",") and self._comma_starts_state():
                self.eat_op(",")
                elems.append(self.parse_state_unit())
                is_seq = True
            else:
                break
        elem = elems[-1]
        for prev in reversed(elems[:-1]):
            elem = ast.NextStateElement(prev, elem)
        return elem, is_seq

    def _comma_starts_state(self) -> bool:
        """After a comma, does a new sequence element start? (vs select list etc.)"""
        t = self.peek(1)
        if t.type != TokenType.IDENT:
            return t.type == TokenType.OP and t.value == "("
        if t.lower() in ("every", "not"):
            return True
        t2 = self.peek(2)
        return t2.type == TokenType.OP and t2.value in ("=", "[", "+", "*", "?")

    def parse_state_unit(self) -> ast.StateElement:
        if self.try_kw("every"):
            if self.try_op("("):
                inner, _ = self.parse_state_chain()
                self.eat_op(")")
                within = None
                if self.try_kw("within"):
                    within = ast.TimeConstant(self.parse_time_value())
                return ast.EveryStateElement(inner, within)
            inner = self.parse_state_source()
            return ast.EveryStateElement(inner)
        if self.try_op("("):
            inner, _ = self.parse_state_chain()
            self.eat_op(")")
            within = None
            if self.try_kw("within"):
                within = ast.TimeConstant(self.parse_time_value())
            if within is not None:
                inner = _attach_within(inner, within)
            return inner
        return self.parse_state_source()

    def parse_state_source(self) -> ast.StateElement:
        """One pattern source: absent / logical / counting / plain."""
        if self.try_kw("not"):
            stream = self.parse_basic_state_stream()
            if self.try_kw("and"):
                right = self.parse_basic_state_stream()
                return ast.LogicalStateElement(
                    ast.AbsentStreamStateElement(stream),
                    "and", ast.StreamStateElement(right))
            self.eat_kw("for")
            wait = ast.TimeConstant(self.parse_time_value())
            absent = ast.AbsentStreamStateElement(stream, waiting_time=wait)
            # `not X for T and|or Y` — a timed absent as a logical side
            # (reference grammar: every_absent_logical_source)
            for op in ("and", "or"):
                if self.try_kw(op):
                    right = self.parse_basic_state_stream()
                    return ast.LogicalStateElement(
                        absent, op, ast.StreamStateElement(right))
            return absent
        stream = self.parse_basic_state_stream()
        # count: e1=S[...]<2:5>
        if self.at_op("<"):
            save = self.i
            self.eat_op("<")
            mn, mx = self._parse_collect()
            if mn is not None or mx is not None:
                self.eat_op(">")
                return ast.CountStateElement(
                    ast.StreamStateElement(stream),
                    mn if mn is not None else 1,
                    mx if mx is not None else ast.CountStateElement.ANY)
            self.i = save
        # sequence postfix +, *, ?
        if self.at_op("+"):
            self.eat_op("+")
            return ast.CountStateElement(ast.StreamStateElement(stream), 1,
                                         ast.CountStateElement.ANY)
        if self.at_op("*"):
            self.eat_op("*")
            return ast.CountStateElement(ast.StreamStateElement(stream), 0,
                                         ast.CountStateElement.ANY)
        if self.at_op("?"):
            self.eat_op("?")
            return ast.CountStateElement(ast.StreamStateElement(stream), 0, 1)
        for op in ("and", "or"):
            if self.try_kw(op):
                if self.try_kw("not"):
                    right = self.parse_basic_state_stream()
                    wait = None
                    if self.try_kw("for"):      # `Y and|or not X for T`
                        wait = ast.TimeConstant(self.parse_time_value())
                    return ast.LogicalStateElement(
                        ast.StreamStateElement(stream), op,
                        ast.AbsentStreamStateElement(right,
                                                     waiting_time=wait))
                right = self.parse_basic_state_stream()
                return ast.LogicalStateElement(
                    ast.StreamStateElement(stream), op,
                    ast.StreamStateElement(right))
        return ast.StreamStateElement(stream)

    def _parse_collect(self) -> tuple[Optional[int], Optional[int]]:
        """`<2:5>` `<2:>` `<:5>` `<3>` — returns (min, max); (None, None) if not a collect."""
        mn = mx = None
        if self.peek().type == TokenType.INT:
            mn = int(self.next().value)
            if self.try_op(":"):
                if self.peek().type == TokenType.INT:
                    mx = int(self.next().value)
            else:
                mx = mn
        elif self.at_op(":"):
            self.eat_op(":")
            if self.peek().type == TokenType.INT:
                mx = int(self.next().value)
                mn = 0
        return mn, mx

    def parse_basic_state_stream(self) -> ast.SingleInputStream:
        """`e1=Stream[filter]#fn(...)` — ref optional, no windows allowed."""
        ref = None
        if self.peek().type == TokenType.IDENT and self.at_op("=", ahead=1):
            ref = self.ident()
            self.eat_op("=")
        sid = self.ident()
        handlers = self.parse_stream_handlers()
        for h in handlers:
            if isinstance(h, ast.WindowHandler):
                raise ParseError("windows are not allowed inside pattern/sequence sources")
        return ast.SingleInputStream(sid, ref, tuple(handlers))

    # -- selector -----------------------------------------------------------

    def parse_selector_block(self) -> ast.Selector:
        select_all = False
        attributes: list[ast.OutputAttribute] = []
        if self.try_kw("select"):
            if self.try_op("*"):
                select_all = True
            else:
                while True:
                    expr = self.parse_expression()
                    rename = None
                    if self.try_kw("as"):
                        rename = self.ident()
                    attributes.append(ast.OutputAttribute(expr, rename))
                    if not self.try_op(","):
                        break
        else:
            select_all = True
        group_by: list[ast.Variable] = []
        if self.at_kw("group"):
            self.eat_kw("group")
            self.eat_kw("by")
            while True:
                group_by.append(self._parse_variable_ref())
                if not self.try_op(","):
                    break
        having = None
        if self.try_kw("having"):
            having = self.parse_expression()
        order_by: list[ast.OrderByAttribute] = []
        if self.at_kw("order"):
            self.eat_kw("order")
            self.eat_kw("by")
            while True:
                v = self._parse_variable_ref()
                d = ast.OrderDir.ASC
                if self.try_kw("asc"):
                    pass
                elif self.try_kw("desc"):
                    d = ast.OrderDir.DESC
                order_by.append(ast.OrderByAttribute(v, d))
                if not self.try_op(","):
                    break
        limit = offset = None
        if self.try_kw("limit"):
            limit = int(self.next().value)
        if self.try_kw("offset"):
            offset = int(self.next().value)
        return ast.Selector(select_all, tuple(attributes), tuple(group_by),
                            having, tuple(order_by), limit, offset)

    def _parse_variable_ref(self) -> ast.Variable:
        name = self.ident()
        if self.try_op("."):
            return ast.Variable(self.ident(), stream_ref=name)
        return ast.Variable(name)

    # -- output rate & action ------------------------------------------------

    def parse_output_rate(self) -> ast.OutputRate:
        if not self.at_kw("output"):
            return None
        # `output` may also start `output snapshot every..` — or the action
        # keyword sequence for window definitions is handled elsewhere.
        save = self.i
        self.eat_kw("output")
        rtype = ast.RateType.ALL
        if self.try_kw("snapshot"):
            self.eat_kw("every")
            return ast.SnapshotOutputRate(self.parse_time_value())
        if self.try_kw("first"):
            rtype = ast.RateType.FIRST
        elif self.try_kw("last"):
            rtype = ast.RateType.LAST
        elif self.try_kw("all"):
            rtype = ast.RateType.ALL
        if not self.try_kw("every"):
            self.i = save
            return None
        if self.peek().type in (TokenType.INT, TokenType.LONG):
            val = int(self.next().value)
            if self.at_kw("events"):
                self.eat_kw("events")
                return ast.EventOutputRate(val, rtype)
            unit = self.ident().lower()
            if unit not in _TIME_UNITS_MS:
                raise ParseError(f"expected time unit or 'events', got {unit!r}")
            ms = val * _TIME_UNITS_MS[unit]
            # allow compound `1 min 30 sec`
            while self.peek().type in (TokenType.INT, TokenType.LONG) and \
                    self.peek(1).type == TokenType.IDENT and self.peek(1).lower() in _TIME_UNITS_MS:
                v2 = int(self.next().value)
                ms += v2 * _TIME_UNITS_MS[self.ident().lower()]
            return ast.TimeOutputRate(ms, rtype)
        raise ParseError("expected count or time after 'every'", self.peek())

    def parse_events_for(self) -> ast.OutputEventsFor:
        if self.try_kw("current"):
            self.eat_kw("events")
            return ast.OutputEventsFor.CURRENT
        if self.try_kw("expired"):
            self.eat_kw("events")
            return ast.OutputEventsFor.EXPIRED
        if self.try_kw("all"):
            self.eat_kw("events")
            return ast.OutputEventsFor.ALL
        self.eat_kw("events")
        return ast.OutputEventsFor.CURRENT

    def parse_output_action(self) -> ast.OutputStreamAction:
        if self.try_kw("insert"):
            ef = ast.OutputEventsFor.CURRENT
            if self.at_kw("current", "expired", "all"):
                ef = self.parse_events_for()
            if self.try_kw("overwrite"):   # legacy `insert overwrite` -> update or insert
                self.eat_kw("into")
                target, is_fault, is_inner = self._output_target()
                on = None
                if self.try_kw("on"):
                    on = self.parse_expression()
                return ast.UpdateOrInsertTable(target, on or ast.Constant(True, AttrType.BOOL))
            self.eat_kw("into")
            target, is_fault, is_inner = self._output_target()
            return ast.InsertInto(target, ef, is_fault, is_inner)
        if self.try_kw("delete"):
            target, _, _ = self._output_target()
            ef = ast.OutputEventsFor.CURRENT
            if self.try_kw("for"):
                ef = self.parse_events_for()
            self.eat_kw("on")
            return ast.DeleteFrom(target, self.parse_expression(), ef)
        if self.try_kw("update"):
            if self.try_kw("or"):
                self.eat_kw("insert")
                self.eat_kw("into")
                target, _, _ = self._output_target()
                sets = self._parse_set_clauses()
                self.eat_kw("on")
                return ast.UpdateOrInsertTable(target, self.parse_expression(), sets)
            target, _, _ = self._output_target()
            ef = ast.OutputEventsFor.CURRENT
            if self.try_kw("for"):
                ef = self.parse_events_for()
            sets = self._parse_set_clauses()
            self.eat_kw("on")
            return ast.UpdateTable(target, self.parse_expression(), sets, ef)
        if self.try_kw("return"):
            ef = ast.OutputEventsFor.CURRENT
            if self.at_kw("current", "expired", "all"):
                ef = self.parse_events_for()
            return ast.ReturnAction(ef)
        raise ParseError("expected insert/delete/update/return", self.peek())

    def _output_target(self) -> tuple[str, bool, bool]:
        is_inner = bool(self.try_op("#"))
        is_fault = bool(self.try_op("!"))
        return self.ident(), is_fault, is_inner

    def _parse_set_clauses(self) -> tuple[ast.UpdateSetClause, ...]:
        if not self.try_kw("set"):
            return ()
        sets = []
        while True:
            var = self._parse_variable_ref()
            self.eat_op("=")
            sets.append(ast.UpdateSetClause(var, self.parse_expression()))
            if not self.try_op(","):
                break
        return tuple(sets)

    # -- partitions ----------------------------------------------------------

    def parse_partition(self, annotations) -> ast.Partition:
        self.eat_kw("partition")
        self.eat_kw("with")
        self.eat_op("(")
        keys = []
        while True:
            keys.append(self.parse_partition_key())
            if not self.try_op(","):
                break
        self.eat_op(")")
        self.eat_kw("begin")
        queries = []
        while not self.at_kw("end"):
            q_anns = self.parse_annotations()
            queries.append(self.parse_query_body(tuple(q_anns)))
            self.try_op(";")
        self.eat_kw("end")
        return ast.Partition(tuple(keys), tuple(queries), annotations)

    def parse_partition_key(self) -> ast.PartitionKey:
        expr = self.parse_expression()
        if self.try_kw("as"):
            # range partition: cond as 'label' [or cond as 'label']... of Stream
            t = self.next()
            ranges = [ast.RangePartitionCase(expr, t.value)]
            while self.try_kw("or"):
                cond = self.parse_expression()
                self.eat_kw("as")
                t = self.next()
                ranges.append(ast.RangePartitionCase(cond, t.value))
            self.eat_kw("of")
            sid = self.ident()
            return ast.PartitionKey(sid, None, tuple(ranges))
        self.eat_kw("of")
        sid = self.ident()
        return ast.PartitionKey(sid, expr)

    # -- store queries -------------------------------------------------------

    def parse_store_query(self) -> ast.StoreQuery:
        if self.try_kw("select"):
            # `select ... insert into T` without from — unsupported; rewind
            raise ParseError("store query must start with from", self.peek())
        self.eat_kw("from")
        is_inner = bool(self.try_op("#"))
        sid = self.ident()
        handlers = []
        within = per = None
        if self.try_kw("on"):
            handlers.append(ast.Filter(self.parse_expression()))
        if self.try_kw("within"):
            within = self.parse_within_value()
        if self.try_kw("per"):
            per = self.parse_expression()
        inp = ast.SingleInputStream(sid, None, tuple(handlers), is_inner)
        selector = self.parse_selector_block()
        action: Optional[ast.OutputStreamAction] = None
        if self.at_kw("insert", "update", "delete", "return"):
            action = self.parse_output_action()
        return ast.StoreQuery(inp, selector, action, within, per)

    # -- time ----------------------------------------------------------------

    def parse_time_value(self) -> int:
        total = 0
        seen = False
        while self.peek().type in (TokenType.INT, TokenType.LONG):
            val = int(self.next().value)
            unit = self.ident().lower()
            if unit not in _TIME_UNITS_MS:
                raise ParseError(f"unknown time unit {unit!r}", self.peek())
            total += val * _TIME_UNITS_MS[unit]
            seen = True
        if not seen:
            raise ParseError("expected time value", self.peek())
        return total

    # -- expressions ---------------------------------------------------------

    def parse_expression(self) -> ast.Expression:
        return self.parse_or()

    def parse_or(self) -> ast.Expression:
        left = self.parse_and()
        while self.at_kw("or"):
            # `or` inside partition-range / pattern contexts stops at `as`/`of`
            if self.at_kw("as", ahead=1):
                break
            self.eat_kw("or")
            left = ast.Or(left, self.parse_and())
        return left

    def parse_and(self) -> ast.Expression:
        left = self.parse_not()
        while self.try_kw("and"):
            left = ast.And(left, self.parse_not())
        return left

    def parse_not(self) -> ast.Expression:
        if self.try_kw("not"):
            return ast.Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expression:
        left = self.parse_additive()
        while True:
            if self.at_op("==") or self.at_op("!=") or self.at_op("<=") or \
                    self.at_op(">=") or self.at_op("<") or self.at_op(">"):
                op = self.next().value
                right = self.parse_additive()
                left = ast.Compare(left, CompareOp(op), right)
            elif self.at_kw("is") and self.at_kw("null", ahead=1):
                self.next()
                self.next()
                if isinstance(left, ast.Variable) and left.attribute is None:
                    left = ast.IsNull(stream_ref=left.stream_ref, index=left.index)
                else:
                    left = ast.IsNull(expr=left)
            elif self.at_kw("in") and not self.at_kw("insert", ahead=0):
                self.eat_kw("in")
                left = ast.In(left, self.ident())
            else:
                return left

    def parse_additive(self) -> ast.Expression:
        left = self.parse_multiplicative()
        while self.at_op("+") or self.at_op("-"):
            op = self.next().value
            right = self.parse_multiplicative()
            left = ast.Math(left, MathOp(op), right)
        return left

    def parse_multiplicative(self) -> ast.Expression:
        left = self.parse_unary()
        while self.at_op("*") or self.at_op("/") or self.at_op("%"):
            op = self.next().value
            right = self.parse_unary()
            left = ast.Math(left, MathOp(op), right)
        return left

    def parse_unary(self) -> ast.Expression:
        if self.at_op("-"):
            self.eat_op("-")
            inner = self.parse_unary()
            if isinstance(inner, ast.Constant) and inner.type in (
                    AttrType.INT, AttrType.LONG, AttrType.FLOAT, AttrType.DOUBLE):
                return ast.Constant(-inner.value, inner.type)
            return ast.Math(ast.Constant(0, AttrType.INT), MathOp.SUB, inner)
        if self.at_op("+"):
            self.eat_op("+")
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> ast.Expression:
        t = self.peek()
        if self.try_op("("):
            e = self.parse_expression()
            self.eat_op(")")
            return e
        if t.type == TokenType.STRING:
            self.next()
            return ast.Constant(t.value, AttrType.STRING)
        if t.type == TokenType.INT:
            self.next()
            # time constant: INT unit
            if self.peek().type == TokenType.IDENT and self.peek().lower() in _TIME_UNITS_MS \
                    and not self.at_op("(", ahead=1) and not self.at_op(".", ahead=1):
                total = int(t.value) * _TIME_UNITS_MS[self.ident().lower()]
                while self.peek().type == TokenType.INT and \
                        self.peek(1).type == TokenType.IDENT and self.peek(1).lower() in _TIME_UNITS_MS:
                    v = int(self.next().value)
                    total += v * _TIME_UNITS_MS[self.ident().lower()]
                return ast.TimeConstant(total)
            return ast.Constant(int(t.value), AttrType.INT)
        if t.type == TokenType.LONG:
            self.next()
            return ast.Constant(int(t.value), AttrType.LONG)
        if t.type == TokenType.FLOAT:
            self.next()
            return ast.Constant(float(t.value), AttrType.FLOAT)
        if t.type == TokenType.DOUBLE:
            self.next()
            return ast.Constant(float(t.value), AttrType.DOUBLE)
        if t.type == TokenType.IDENT:
            low = t.lower()
            if low == "true":
                self.next()
                return ast.Constant(True, AttrType.BOOL)
            if low == "false":
                self.next()
                return ast.Constant(False, AttrType.BOOL)
            return self.parse_name_expression()
        raise ParseError("expected expression", t)

    def parse_name_expression(self) -> ast.Expression:
        """ident-led expression: variable, dotted variable, function call,
        ns:function, e1[0].attr, stream-ref for `is null`."""
        name = self.ident()
        # ns:function(...)
        if self.at_op(":") and self.peek(1).type == TokenType.IDENT and \
                self.at_op("(", ahead=2):
            self.eat_op(":")
            fname = self.ident()
            args = self.parse_call_args()
            return ast.FunctionCall(fname, args, namespace=name)
        if self.at_op("("):
            args = self.parse_call_args()
            return ast.FunctionCall(name, args)
        index = None
        if self.at_op("["):
            # e1[0].attr or e1[last].attr
            save = self.i
            self.eat_op("[")
            if self.peek().type == TokenType.INT and self.at_op("]", ahead=1):
                index = int(self.next().value)
                self.eat_op("]")
            elif self.at_kw("last") and self.at_op("]", ahead=1):
                self.next()
                index = "last"
                self.eat_op("]")
            elif self.at_kw("last") and self.at_op("-", ahead=1):
                self.next()
                self.eat_op("-")
                off = int(self.next().value)
                index = f"last-{off}"
                self.eat_op("]")
            else:
                self.i = save  # not an index — it's a filter bracket upstream
        if self.try_op("."):
            attr = self.ident()
            if self.at_op("("):
                # method-style f(x).y() not supported
                raise ParseError("method call syntax not supported", self.peek())
            return ast.Variable(attr, stream_ref=name, index=index)
        if index is not None:
            return ast.Variable(None, stream_ref=name, index=index)  # e1[0] is null
        return ast.Variable(name)


def _attach_within(elem: ast.StateElement, within: ast.TimeConstant) -> ast.StateElement:
    import dataclasses as dc
    return dc.replace(elem, within=within)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def parse(text: str) -> ast.SiddhiApp:
    return Parser(text).parse_app()


def parse_query(text: str) -> ast.Query:
    p = Parser(text)
    anns = p.parse_annotations()
    q = p.parse_query_body(tuple(anns))
    p.try_op(";")
    if p.peek().type != TokenType.EOF:
        raise ParseError("trailing input after query", p.peek())
    return q


def parse_store_query(text: str) -> ast.StoreQuery:
    p = Parser(text)
    sq = p.parse_store_query()
    p.try_op(";")
    if p.peek().type != TokenType.EOF:
        raise ParseError("trailing input after store query", p.peek())
    return sq


def parse_expression(text: str) -> ast.Expression:
    p = Parser(text)
    e = p.parse_expression()
    if p.peek().type != TokenType.EOF:
        raise ParseError("trailing input after expression", p.peek())
    return e


def parse_time(text: str) -> int:
    return Parser(text).parse_time_value()
