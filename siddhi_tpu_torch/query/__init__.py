"""Language front end: SiddhiQL-compatible lexer/parser and typed AST."""
from . import ast
from .parser import (ParseError, parse, parse_expression, parse_query,
                     parse_store_query, parse_time)

__all__ = ["ast", "parse", "parse_query", "parse_store_query",
           "parse_expression", "parse_time", "ParseError"]
