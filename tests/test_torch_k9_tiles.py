"""K9 `join_probe` at the edges of its tiles, on a CUDA card (marker `gpu`).

K9 (csrc/join_probe.cu) takes tiles of 4-32 consecutive probes, stages
the opposite columns of each tile's window in a shared-memory ring, 256
positions a chunk, runs `on` once per visible pair, keeps the match bits
and writes the pairs at slots from a look-back over the earlier tiles'
counts.  Each case builds one direction's inputs from a numpy seed and
holds the kernel's outputs (the exact pair total, pairs, computed
columns, miss words) to `join_probe_plain` with tolerance 0, and checks
that the call made at most two kernel launches (one without an opposite
filter).  Two more tests: two prepared launches in flight at once on two
streams (each holds its own look-back state), and the launcher refusing
a parameter block laid out for other sizes than its JP_CHUNK/JP_GROUP.
The cases:

- `mw_chunks`: a window of 1024 (four chunks) over 3000 batch rows;
- `interleaved`: probes and opposite rows interleaved one by one, so a
  tile's probes see different ranges;
- `mirror_batch`: ranges that start in the mirror and end in the batch;
- `o_pass_sparse`: an opposite filter passing 1% of the rows (the rank
  scan's gather);
- `self_join`: both sides one stream (the same seqs: a strict `<`);
- `mw0`: a windowless opposite side (nothing visible, every passed probe
  a miss);
- `outer_odd`: miss words over 77 probes with a probe filter (tiles of 4
  share a word; the last one clears the bits past n_p);
- `m_small`: M far below the pair total (the total exact, slots past M
  not written);
- `np1`: one probe;
- `all_vts`: computed columns of every VM value type;
- `no_on`: no `on` condition (every visible pair matches);
- `many_tiles`: 40,000 probes (tiles of 32, a long look-back chain);
- `global_bits`: a window of 300,000 (a probe's bitmap past 32 KB: the
  bitmaps in device memory).

Run on the card with
`python -m pytest --noconftest -m gpu tests/test_torch_k9_tiles.py`;
without one every test skips (decided inside the `cuda` fixture)."""
import numpy as np
import pytest
import torch

from siddhi_tpu_torch.core.expr import (F32_MODE, VT_OF_TORCH,
                                        MultiStreamContext,
                                        compile_expression, compute_dtypes,
                                        emit_program)
from siddhi_tpu_torch.core.schema import StreamSchema, StringTable
from siddhi_tpu_torch.kernels import LAUNCHES
from siddhi_tpu_torch.query import parse, parse_expression
from siddhi_tpu_torch.replay import same

pytestmark = pytest.mark.gpu

CASES = ("mw_chunks", "interleaved", "mirror_batch", "o_pass_sparse",
         "self_join", "mw0", "outer_odd", "m_small", "np1", "all_vts",
         "no_on", "many_tiles", "global_bits")
ATTRS = ("k", "p", "v", "f", "d")
SCHEMA = "define stream S (k int, p float, v long, f bool, d double);"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cols(rng, n: int) -> dict:
    return {"k": torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
            "p": torch.from_numpy(rng.uniform(-5, 5, n).astype(np.float32)),
            "v": torch.from_numpy(rng.integers(-9, 9, n)),
            "f": torch.from_numpy(rng.integers(0, 2, n).astype(bool)),
            "d": torch.from_numpy(rng.uniform(-5, 5, n))}


def _programs(on_text, out_texts):
    """`on` and the computed programs over probe slots a.* and opposite
    slots b.*; DOUBLE stays float64 in a program that reads `d`."""
    schema = StreamSchema.of(parse(SCHEMA).stream_definitions["S"])
    ctx = MultiStreamContext({"a": schema, "b": schema}, StringTable())
    keys = [f"a.{x}" for x in ATTRS] + [f"b.{x}" for x in ATTRS]
    dt = {"k": torch.int32, "p": torch.float32, "v": torch.int64,
          "f": torch.bool, "d": torch.float64}
    slots = {k: (i, VT_OF_TORCH[dt[k[2:]]]) for i, k in enumerate(keys)}

    def prog(text):
        node = compile_expression(parse_expression(text), ctx).node
        return emit_program(node, slots)

    def mode(text):
        return compute_dtypes(None if ".d" in text else F32_MODE)
    with mode(on_text or ""):
        on = prog(on_text) if on_text else None
    outs = []
    for t in out_texts:
        with mode(t):
            outs.append(prog(t))
    return on, outs


def _inputs(case: str) -> tuple:
    """(args, kwargs) of one direction of `case` (see the module doc)."""
    rng = np.random.default_rng(CASES.index(case) + 11)
    n_p, n_o, NO, Lo, Mw = 1000, 3000, 1024, 700, 1024
    on_text = "a.k == b.k and a.p > b.p - 1.5"
    outs = ["a.p * b.p + 0.25", "b.v * 3 + a.k"]
    p_filter, o_filter, outer, M = 0.8, 0.7, True, 1 << 18
    interleave = 0.5
    if case == "interleaved":
        interleave = None
    elif case == "mirror_batch":
        n_o, Lo = 400, 1024
    elif case == "o_pass_sparse":
        o_filter = 0.01
    elif case == "mw0":
        Mw, NO, Lo = 0, 1, 0
    elif case == "outer_odd":
        n_p, on_text = 77, "a.k == b.k and a.p > b.p + 9.0"
    elif case == "m_small":
        M = 16
    elif case == "np1":
        n_p, p_filter = 1, None
    elif case == "all_vts":
        outs = ["b.f or a.p > 0", "a.k - b.k", "b.v * 3 + a.v",
                "a.p * b.p + 0.25", "a.d - b.d * 1.5"]
    elif case == "no_on":
        on_text, p_filter = None, None
    elif case == "many_tiles":
        n_p, n_o, o_filter = 40_000, 2000, None
    elif case == "global_bits":
        n_p, n_o, NO, Lo, Mw, M = 40, 4000, 300_000, 299_000, 300_000, 1 << 22
        on_text = "a.k == b.k"
        outs = ["b.p"]
    on, progs = _programs(on_text, outs)
    pc, mc, bc = _cols(rng, n_p), _cols(rng, NO), _cols(rng, n_o)
    if case == "self_join":         # one stream on both sides
        n_o, bc = n_p, pc
        seq = np.arange(10_000, 10_000 + n_p)
        p_seq = o_seq = seq
    elif interleave is None:        # probe, opposite, probe, ...
        n_o = n_p
        p_seq = 10_000 + 2 * np.arange(n_p)
        o_seq = p_seq + 1
    else:
        seq = np.sort(rng.permutation(np.arange(10_000, 10_000 + n_p + n_o)))
        pick = np.zeros(len(seq), bool)
        pick[rng.choice(len(seq), n_p, replace=False)] = True
        p_seq, o_seq = seq[pick], seq[~pick]
    from siddhi_tpu_torch.kernels.expr_eval import pack_mask
    p_pass = None if p_filter is None else \
        pack_mask(torch.from_numpy(rng.random(n_p) < p_filter))
    o_pass = None if o_filter is None else \
        pack_mask(torch.from_numpy(rng.random(n_o) < o_filter))
    if case == "self_join":
        o_pass = p_pass
    args = ([pc[x] for x in ATTRS], [(mc[x], bc[x]) for x in ATTRS],
            torch.from_numpy(np.asarray(p_seq, np.int64)),
            torch.from_numpy(np.asarray(o_seq, np.int64)), p_pass, o_pass)
    kw = dict(n_p=n_p, n_o=n_o, Lo=Lo, NO=NO, Mw=Mw, on=on, outs=progs,
              M=M, outer=outer)
    return args, kw


def _to(args, dev):
    p_cols, o_cols, p_seq, o_seq, p_pass, o_pass = args
    return ([c.to(dev) for c in p_cols],
            [(m.to(dev), b.to(dev)) for m, b in o_cols],
            p_seq.to(dev), o_seq.to(dev),
            None if p_pass is None else p_pass.to(dev),
            None if o_pass is None else o_pass.to(dev))


@pytest.mark.parametrize("case", CASES)
def test_k9_tiles_match_plain(cuda, case):
    from siddhi_tpu_torch.kernels import join_probe as k9
    args, kw = _inputs(case)
    want = k9.join_probe_plain(*args, **kw)
    dev = _to(args, cuda)
    before = LAUNCHES["join_probe"]
    launch = k9.prepare(*dev, **kw)
    got = launch()
    torch.cuda.synchronize()
    assert LAUNCHES["join_probe"] == before + 1
    assert launch.params.launched == (2 if dev[5] is not None else 1)
    total = int(want[0][0])
    if case == "mw0":
        assert total == 0 and int(want[4].sum()) != 0
    elif case == "m_small":
        assert total > kw["M"]
    else:
        assert total > 0
    if case == "outer_odd":
        assert int(want[4].sum()) != 0
    for g, w in zip([got[0], got[1], got[2], *got[3], got[4]],
                    [want[0], want[1], want[2], *want[3], want[4]]):
        assert same(None if g is None else g.cpu(), w), case
    # a second launch of the same prepared call (the look-back state it
    # left behind is clear) gives the same outputs
    again = launch()
    torch.cuda.synchronize()
    for g, w in zip([again[0], again[1], again[2], *again[3], again[4]],
                    [want[0], want[1], want[2], *want[3], want[4]]):
        assert same(None if g is None else g.cpu(), w), case


def test_k9_launches_on_two_streams(cuda):
    """Two prepared launches in flight at once, on two streams, each
    several times: every launch holds its own look-back state, so
    neither mixes the other's tickets or tile words."""
    from siddhi_tpu_torch.kernels import join_probe as k9
    calls = []
    for case in ("many_tiles", "o_pass_sparse"):
        args, kw = _inputs(case)
        calls.append((k9.prepare(*_to(args, cuda), **kw),
                      k9.join_probe_plain(*args, **kw)))
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    for s in streams:               # the inputs and zeroed state are ready
        s.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(3):
        for (launch, _want), s in zip(calls, streams):
            with torch.cuda.stream(s):
                launch()
    torch.cuda.synchronize()
    for launch, want in calls:
        got = launch.outputs
        for g, w in zip([got[0], got[1], got[2], *got[3], got[4]],
                        [want[0], want[1], want[2], *want[3], want[4]]):
            assert same(None if g is None else g.cpu(), w)


def test_k9_launcher_checks_its_layout(cuda):
    """The host lays shared memory out for CHUNK window positions a ring
    slot and GROUP probes a pass; the launcher refuses a parameter block
    made for other sizes than the kernel's JP_CHUNK and JP_GROUP."""
    from siddhi_tpu_torch.kernels import join_probe as k9
    args, kw = _inputs("mw_chunks")
    launch = k9.prepare(*_to(args, cuda), **kw)
    assert (launch.params.chunk, launch.params.group) == (k9.CHUNK, k9.GROUP)
    launch.params.group = k9.GROUP + 1
    with pytest.raises(RuntimeError, match="join_probe_launch"):
        launch()
