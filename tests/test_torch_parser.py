"""The port's query front end (siddhi_tpu_torch/query, a copy of the JAX
package's) parses every app of the port's slice to the same AST.  The
two packages' dataclasses are different classes, so the ASTs compare by
their repr (class names, fields and enum members; no module paths)."""
import pytest

import siddhi_tpu.query as jq
import siddhi_tpu_torch.query as tq

STOCK = "define stream StockStream (symbol string, price double, volume int);\n"
APPS = {
    "c1": STOCK + "@info(name='q') from StockStream[price > 100] "
                  "select * insert into Out;",
    "c3": STOCK + "@info(name='q') from every e1=StockStream[price > 100] -> "
                  "e2=StockStream[price > e1.price] within 1 sec "
                  "select e1.price as p1, e2.price as p2 insert into Out;",
    "c4": "@app:partitionCapacity(1000)\n@app:deviceSlots(32)\n" + STOCK + """
        partition with (symbol of StockStream) begin
          @info(name='q')
          from every e1=StockStream[price > 100] -> e2=StockStream[price > e1.price]
            -> e3=StockStream[price > e2.price] within 10 sec
          select e1.price as p1, e2.price as p2, e3.price as p3 insert into Out;
        end;""",
    "sequence": STOCK + "from every e1=StockStream[price > 120], "
                        "e2=StockStream[price < e1.price] within 1 sec "
                        "select e1.symbol as s, e2.price as p insert into Out;",
    "two_stream": "define stream A (k string, x int);\n"
                  "define stream B (k string, y double);\n"
                  "partition with (k of A, k of B) begin "
                  "from every e1=A[x > 3] -> e2=B[y > e1.x] within 100 ms "
                  "select e1.x as x, e2.y as y insert into Out; end;",
    "having": STOCK + "from e1=StockStream[price > 120] -> "
                      "e2=StockStream[price > e1.price] "
                      "select e1.price as p1, e2.price as p2 "
                      "having p2 - p1 > 5.0 insert into Out;",
    "expressions": STOCK + "from StockStream[(volume / 7 > 3 and not "
                           "(symbol == 'IBM')) or price % 2.0 == 0.5] "
                           "select ifThenElse(volume > 500, price, -1.0) "
                           "as c, math:abs(volume - 500) as d, "
                           "eventTimestamp() as t insert into Out;",
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_same_ast(name):
    assert repr(tq.parse(APPS[name])) == repr(jq.parse(APPS[name]))


@pytest.mark.parametrize("text", [
    "a + b * 2 > c / 3 and not d",
    "ifThenElse(x > 1, 2.5, 3L) == 2.5",
    "s == 'K7' or s is null",
])
def test_same_expression_ast(text):
    assert repr(tq.parse_expression(text)) == repr(jq.parse_expression(text))
