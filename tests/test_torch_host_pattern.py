"""The port's host matcher (`interp/nfa.py` PatternMatcher through
`interp/engine.py` InterpPatternQueryPlan) and its per-key partition
clones (`core/partition.py` PartitionGroup) against the JAX package's
host paths on the CPU.

Both fold every value in Python floats, so every comparison has tolerance
0: the same seeded tape goes through the JAX package and the port under
`@app:devicePatterns('never')` (unless a case says otherwise), and the
rows must be equal, in order, timestamps included.  The shapes come from
tests/test_patterns.py and tests/test_pattern_matrix.py: `every` and
one-shot heads with `within`, counts, `and`/`or`, `not ... for` under
`@app:playback` and on the wall clock (`set_time`), sequences, `e[last]`
and `e[last-2]`, a selector over a maybe-absent ref, aggregating
selectors with `group by` and `having`, `order by`/`limit`/`offset`, and
every output rate limit.  Partitions: value, range and computed keys;
the flagship at 16 keys on the port's host clones, its device plan on
the CPU and the JAX host; the routing rules (warnings, 'always');
carry-over of a JAX host plan's state through `host_state_from_jax`."""
import functools
import warnings

import numpy as np
import pytest

import siddhi_tpu

import siddhi_tpu_torch
from siddhi_tpu_torch.core.partition import PartitionGroup
from siddhi_tpu_torch.core.pattern_plan import DevicePatternPlan
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.interp.engine import InterpPatternQueryPlan
from siddhi_tpu_torch.weights import host_state_from_jax

NEVER = "@app:devicePatterns('never')\n"
PLAYBACK = "@app:playback\n"
S3 = "".join(f"define stream S{i} (sym string, price double, volume int);\n"
             for i in (1, 2, 3))

# (name, body, clock): clock "playback" (deadlines fire on events), "wall"
# (set_time after every flush and past the tape) or None (no timers)
SHAPES = [
    ("every_within", "from every e1=S1[price > 20] -> e2=S1[price > "
     "e1.price] within 1 sec select e1.price as a, e2.price as b", None),
    ("one_shot", "from e1=S1[price > 30] -> e2=S2[price > e1.price] "
     "select e1.sym as s, e2.price as b", None),
    ("every_two_streams", "from every e1=S1[price > 40] -> e2=S2[price < "
     "e1.price] within 500 milliseconds select e1.sym as s, e1.price as a, "
     "e2.price as b, e2.volume as v", None),
    ("count_nm", "from every e1=S1[price > 35]<2:3> -> e2=S2[price < 15] "
     "within 2 sec select e1[0].price as a, e1[1].price as b, e2.price "
     "as c", None),
    ("count_0n", "from e1=S1[price > 40]<0:2> -> e2=S2[price < 10] "
     "select e1[0].price as a, e2.price as c", None),
    ("count_plus", "from every e1=S1[price > 45]<1:> -> e2=S3[price < 5] "
     "within 1 sec select e1[0].price as a, e1[last].price as l, "
     "e2.price as c", None),
    ("and", "from every e1=S1[price > 30] and e2=S2[price > 30] -> "
     "e3=S3[price < 20] within 2 sec select e1.price as a, e2.price as b, "
     "e3.price as c", None),
    ("or", "from every e1=S1[price > 50] -> e2=S2[price < 10] or "
     "e3=S3[volume > 90] within 2 sec select e1.price as a, e2.price "
     "as b, e3.volume as v", None),
    ("not_for_playback", "from every e1=S1[price > 45] -> not S2[price > "
     "e1.price] for 1 sec select e1.price as a, e1.volume as v", "playback"),
    ("not_for_wall", "from every e1=S1[price > 45] -> not S2[price > "
     "e1.price] for 1 sec select e1.price as a, e1.volume as v", "wall"),
    ("not_for_then", "from every e1=S1[price > 50] -> not S2[price > 55] "
     "for 500 milliseconds -> e3=S3[price > e1.price] select e1.price as "
     "a, e3.price as c", "playback"),
    ("not_head", "from not S1[price > 55] for 1 sec -> e2=S2[price > 30] "
     "select e2.price as b", "wall"),
    ("not_and", "from e1=S1[price > 10] -> not S2[price > 20] and "
     "e3=S3[price > 30] select e1.price as a, e3.price as c", None),
    ("sequence", "from every e1=S1[price > 20], e2=S1[price > e1.price] "
     "select e1.price as a, e2.price as b", None),
    ("sequence_count", "from every e1=S1[price > 20], e2=S1[price > 20]"
     "<1:2>, e3=S1[price < 20] select e1.price as a, e2[0].price as b, "
     "e3.price as c", None),
    ("last", "from every e1=S1[price > 30]<2:4> -> e2=S2[price < 10] "
     "within 3 sec select e1[last].price as l, e1[last-1].price as l1, "
     "e2.price as c", None),
    ("last_2", "from every e1=S1[price > 30]<1:3> -> e2=S2[price < 10] "
     "within 3 sec select e1[last-2].price as a, e1[last].price as l, "
     "e2.price as c", None),
    ("maybe_absent", "from every e1=S1[price > 50] -> e2=S2[price < 10] "
     "or e3=S3[volume > 90] within 2 sec select e1.price as a, "
     "e3.volume + 1 as v, e2.price is null as n", None),
    ("group_by", "from every e1=S1[price > 30] -> e2=S2[price > e1.price] "
     "within 2 sec select e1.sym as s, sum(e2.price) as t, count() as n, "
     "avg(e1.price) as m, min(e2.price) as lo, max(e2.volume) as hi "
     "group by e1.sym having n > 1", None),
    ("order_limit", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.sym as s, e2.price as p order by p "
     "desc, s limit 3 offset 1", None),
    ("rate_events", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.price as a, e2.price as b output "
     "every 3 events", None),
    ("rate_first_events", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.price as a, e2.price as b output "
     "first every 3 events", None),
    ("rate_last_events", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.price as a, e2.price as b output "
     "last every 3 events", None),
    ("rate_time", "from every e1=S1[price > 30] -> e2=S2[price > e1.price] "
     "within 2 sec select e1.price as a, e2.price as b output every 1 sec",
     "wall"),
    ("rate_last_time", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.price as a, e2.price as b output "
     "last every 1 sec", "wall"),
    ("rate_snapshot", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.price as a, e2.price as b output "
     "snapshot every 1 sec", "wall"),
    ("rate_grouped_first", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.sym as s, e2.price as b group by "
     "e1.sym output first every 2 events", None),
    ("rate_grouped_last", "from every e1=S1[price > 30] -> e2=S2[price > "
     "e1.price] within 2 sec select e1.sym as s, sum(e2.price) as t "
     "group by e1.sym output last every 1 sec", "wall"),
]


def tape(n: int = 360, seed: int = 0, keys: int = 4,
         streams=("S1", "S2", "S3")) -> list:
    """(stream, row, ts): random streams, `keys` symbols, prices on the
    quarter grid in [0, 60), volumes 0-99, gaps of 1-249 ms."""
    rng = np.random.default_rng(seed)
    t, out = 1_000_000, []
    for _ in range(n):
        t += int(rng.integers(1, 250))
        sid = streams[int(rng.integers(0, len(streams)))]
        out.append((sid, (f"K{int(rng.integers(0, keys))}",
                          float(np.round(rng.uniform(0, 60) * 4) / 4),
                          int(rng.integers(0, 100))), t))
    return out


def run(pkg, text: str, ss: list, clock=None, flush: int = 25,
        carry=None, stop=None):
    """Send `ss` row by row, flushing every `flush` events; on the wall
    clock `set_time` enters virtual time before the first event, follows
    each flush and ends 5 s past the tape.  Returns (rows as (ts, row),
    runtime).  `stop` sends only that many events; `carry`, a function
    of the runtime, runs before the first event."""
    kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
    mgr = pkg.SiddhiManager(**kw)
    rt = mgr.create_app_runtime(text)
    out = []
    rt.add_callback("O", lambda evs: out.extend(
        (e.timestamp, e.data) for e in evs))
    if carry is not None:
        carry(rt)
    if clock == "wall":
        rt.set_time(ss[0][2] - 1)
    for i, (sid, row, ts) in enumerate(ss[:stop]):
        rt.input_handler(sid).send(row, timestamp=ts)
        if i % flush == flush - 1:
            rt.flush()
            if clock == "wall":
                rt.set_time(ts)
    rt.flush()
    if clock == "wall" and stop is None:
        rt.set_time(ss[-1][2] + 5000)
    return out, rt


def app(body: str, clock, head: str = NEVER) -> str:
    return (head + (PLAYBACK if clock == "playback" else "") + S3 +
            "@info(name='q') " + body + " insert into O;")


@functools.lru_cache(maxsize=None)
def jax_rows(text: str, clock, seed: int = 0) -> list:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return run(siddhi_tpu, text, tape(seed=seed), clock)[0]


@pytest.mark.parametrize("name,body,clock", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_host_matcher_equals_jax(name, body, clock):
    """Each shape under 'never': the port's host matcher gives the JAX
    host matcher's rows, in order, tolerance 0."""
    text = app(body, clock)
    want = jax_rows(text, clock)
    got, rt = run(siddhi_tpu_torch, text, tape(), clock)
    assert all(isinstance(p, InterpPatternQueryPlan) for p in rt.plans())
    assert got == want, name
    if name not in ("one_shot", "count_0n", "not_and", "not_head"):
        assert len(got) > 2, f"{name}: tape too quiet"


def test_last_2_reads_null_as_in_jax():
    """The JAX host matcher keys captures as `e[last]` and `e[last-1]`
    only, so `e[last-2]` reads NULL there; the port keeps its rows."""
    got = run(siddhi_tpu_torch, app(SHAPES[16][1], None), tape())[0]
    assert got and all(r[1][0] is None for r in got)


# -- routing --------------------------------------------------------------

REFUSED = [s for s in SHAPES if s[0] in (
    "last_2", "maybe_absent", "group_by", "order_limit", "rate_events",
    "rate_grouped_last")]


@pytest.mark.parametrize("name,body,clock", REFUSED,
                         ids=[s[0] for s in REFUSED])
def test_device_refusals_demote_with_a_warning(name, body, clock):
    """Under the default mode a shape the device planner refuses plans the
    host matcher with a RuntimeWarning naming the query and the refusal,
    and gives the JAX package's rows under its 'prefer' (its device
    planner refuses the same shapes); under 'always' it raises."""
    text = app(body, clock, head="")
    with pytest.warns(RuntimeWarning, match=r"query 'q' runs on the host "
                      r"matcher"):
        got, rt = run(siddhi_tpu_torch, text, tape(), clock)
    assert [type(p) for p in rt.plans()] == [InterpPatternQueryPlan]
    want = jax_rows(app(body, clock, head="@app:devicePatterns('prefer')\n"),
                    clock)
    assert got == want and got, name
    with pytest.raises(PlanError):
        siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
            app(body, clock, head="@app:devicePatterns('always')\n"))


def test_device_plan_stays_on_the_device_under_auto():
    """The port's 'auto' keeps an unpartitioned pattern the device plan
    takes on the device (the JAX package's 'auto' sends it to its host
    matcher); the rows are the host matcher's all the same."""
    body = SHAPES[0][1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, rt = run(siddhi_tpu_torch, app(body, None, head=""), tape())
    assert [type(p) for p in rt.plans()] == [DevicePatternPlan]
    assert got == jax_rows(app(body, None), None)


# -- partitions -------------------------------------------------------------

PBODY = ("from every e1=S1[price > 20] -> e2=S1[price > e1.price] -> "
         "e3=S1[price > e2.price] within 2 sec select e1.sym as s, "
         "e1.price as a, e2.price as b, e3.price as c insert into O;")
PARTS = {
    "value": "sym of S1",
    "range": "volume < 30 as 'lo' or volume >= 30 and volume < 70 as 'mid' "
             "or volume >= 70 as 'hi' of S1",
    "computed": "volume % 3 of S1",
}


def part_app(kind: str, head: str) -> str:
    return (head + S3 + f"partition with ({PARTS[kind]}) begin "
            f"@info(name='q') {PBODY} end;")


def s1_tape(n: int = 600, seed: int = 1) -> list:
    return tape(n, seed, streams=("S1",))


@pytest.mark.parametrize("kind", sorted(PARTS))
@pytest.mark.parametrize("mode", ["never", "auto"])
def test_partitions_equal_jax(kind, mode):
    """Value, range and computed keys, each under 'never' (per-key host
    clones in both packages) and the default mode (the device lane axis
    for value and computed keys in both, the clones for a range
    partition, which gives the device no value key), tolerance 0."""
    head = NEVER if mode == "never" else ""
    ss = s1_tape()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = run(siddhi_tpu, part_app(kind, head), ss)[0]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, rt = run(siddhi_tpu_torch, part_app(kind, head), ss)
    clones = mode == "never" or kind == "range"
    kinds = {type(p) for p in rt.plans()}
    if clones:
        assert kinds == {PartitionGroup, InterpPatternQueryPlan}
        group = rt.plans()[0]
        assert len(rt.plans()) == 1 + len(group._key_index) > 2
    else:
        assert kinds == {DevicePatternPlan}
    warned = [x for x in w if "per-key host clones" in str(x.message)]
    assert bool(warned) == (mode == "auto" and kind == "range")
    assert got == want and len(got) > 5


def test_range_partition_always_raises():
    with pytest.raises(PlanError, match="without value partition keys"):
        siddhi_tpu_torch.SiddhiManager(device="cpu").create_app_runtime(
            part_app("range", "@app:devicePatterns('always')\n"))


def test_unkeyed_stream_raises_in_both():
    """Under 'auto' a partitioned pattern over a stream the partition does
    not key goes to the clones, which cannot route it: both packages
    raise PlanError naming the stream."""
    text = (S3 + "partition with (sym of S1) begin @info(name='q') from "
            "every e1=S1[price > 20] -> e2=S2[price > e1.price] select "
            "e1.price as a insert into O; end;")
    for pkg, kw in ((siddhi_tpu, {}), (siddhi_tpu_torch, {"device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(Exception, match=r"unkeyed streams \['S2'\]"):
                pkg.SiddhiManager(**kw).create_app_runtime(text)


def test_flagship_at_16_keys_host_device_and_jax_agree():
    """C4's flagship (`every e1 -> e2 -> e3 within 10 sec`, partitioned by
    symbol) at 16 keys: the port's host clones, the port's device plan on
    the CPU (the kernels' plain versions) and the JAX host clones give
    the same rows (sorted against the device: it and the clones
    interleave keys differently)."""
    from siddhi_tpu_torch.replay import C4
    head = "@app:partitionCapacity(16)\n@app:deviceSlots(32)\n"
    rng = np.random.default_rng(5)
    n = 1500
    syms = [f"K{i}" for i in rng.integers(0, 16, n)]
    prices = np.round(rng.uniform(90.0, 130.0, n) * 4) / 4
    vols = rng.integers(1, 1000, n)
    ss = [("StockStream", (s, float(p), int(v)), 1_700_000_000_000 + 7 * i)
          for i, (s, p, v) in enumerate(zip(syms, prices, vols))]

    def rows(pkg, text):
        kw = {"device": "cpu"} if pkg is siddhi_tpu_torch else {}
        rt = pkg.SiddhiManager(**kw).create_app_runtime(text)
        out = []
        rt.add_callback("Out", lambda evs: out.extend(
            (e.timestamp, e.data) for e in evs))
        for i, (sid, row, ts) in enumerate(ss):
            rt.input_handler(sid).send(row, timestamp=ts)
            if i % 300 == 299:
                rt.flush()
        rt.flush()
        return out, rt
    host, hrt = rows(siddhi_tpu_torch, NEVER + head + C4)
    device, drt = rows(siddhi_tpu_torch, head + C4)
    jax_host, _ = rows(siddhi_tpu, NEVER + head + C4)
    assert isinstance(drt.plans()[0], DevicePatternPlan)
    assert len(hrt.plans()) == 17
    assert host == jax_host and len(host) > 50
    assert sorted(host) == sorted(device)


# -- carry-over -----------------------------------------------------------

CARRY = [s for s in SHAPES if s[0] in (
    "every_within", "count_nm", "not_for_playback", "group_by",
    "rate_grouped_first", "rate_events")]


@pytest.mark.parametrize("name,body,clock", CARRY, ids=[s[0] for s in CARRY])
def test_jax_state_carries_into_the_port(name, body, clock):
    """A JAX host plan's state_dict() halfway through the tape, passed
    through host_state_from_jax, loaded into a port plan whose runtime
    takes the JAX string table and event seq: the port's rows from there
    on equal the JAX package's."""
    text = app(body, clock)
    ss = tape()
    half = len(ss) // 2
    want = jax_rows(text, clock)
    jrows, jrt = run(siddhi_tpu, text, ss, clock, stop=half)
    jplan = jrt._plans[0]
    st = host_state_from_jax(jplan.state_dict())

    def carry(rt):
        rt.strings.restore(jrt.strings.state())
        rt._seq = jrt._seq
        rt.plans()[0].load_state_dict(st)
    got, _ = run(siddhi_tpu_torch, text, ss[half:], clock, carry=carry)
    assert jrows + got == want and got, name


def test_partition_state_carries_into_the_port():
    """A JAX PartitionGroup's key map and each clone's matcher state carry
    over: the port's group rebuilds the clones from the key map and each
    clone loads its JAX twin's state."""
    text = part_app("range", NEVER)
    ss = s1_tape()
    half = len(ss) // 2
    want = run(siddhi_tpu, text, ss)[0]
    jrows, jrt = run(siddhi_tpu, text, ss, stop=half)
    jgroup = next(p for p in jrt._plans if type(p).__name__ ==
                  "PartitionGroup")
    clones = {p.name: p.state_dict() for p in jrt._plans
              if type(p).__name__ == "InterpPatternQueryPlan"}

    def carry(rt):
        rt.strings.restore(jrt.strings.state())
        rt._seq = jrt._seq
        rt.plans()[0].load_state_dict(
            host_state_from_jax(jgroup.state_dict()))
        for p in rt.plans()[1:]:
            p.load_state_dict(host_state_from_jax(clones[p.name]))
    got, rt = run(siddhi_tpu_torch, text, ss[half:], carry=carry)
    assert len(rt.plans()) == 1 + len(clones)
    assert jrows + got == want and got
