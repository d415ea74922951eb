"""Sequential pattern/sequence (CEP NFA) matcher -- reference semantics.

Port of `siddhi_tpu/interp/nfa.py`: the lowering of a pattern's
StateElement tree into linked nodes (`NFACompiler`, which the device chain
lowering reads too, siddhi_tpu/core/nfa_device.py:218), `collect_filters`
(siddhi_tpu/interp/engine.py `_collect_filters`) and the host matcher
(`PM`, `PatternMatcher`), which `interp/engine.py`'s
InterpPatternQueryPlan drives event by event.

Design (the JAX package's, clean-room, semantics first):
  * a partial match (`PM`) holds captured events per state ref and the set
    of nodes where it is pending;
  * `every` lowers to *sticky* entry nodes: a sticky pending PM clones on
    match and stays armed (the reference's addEveryState re-arming);
  * two-phase commit per event: transitions stage their registrations and
    apply after the event is fully processed, so one event can't climb two
    chained states;
  * sequences add strictness: any PM with captures that was eligible but
    did not transition on an event is killed;
  * absent states (`not B for T`) carry deadlines that `on_timer` fires;
    `within` expires a PM lazily when a later event reaches it.
`env_of_captures` gives a selector the captures as env keys (`e1.x`,
`e1[i].x`, `e1[last].x`, `e1[last-1].x`, `e1.__present__`); as in the
JAX package no key is set for `e1[last-2]` and beyond, which read NULL.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

from ..query import ast
from ..core.planner import PlanError
from ..core.runtime import Event

FINAL = None


@dataclass
class Node:
    id: int
    stream_id: str
    ref: str
    filter_fn: Optional[Callable]          # env -> bool
    kind: str = "stream"                   # "stream" | "absent"
    min_count: int = 1
    max_count: int = 1
    within_ms: Optional[int] = None        # expiry for PMs pending here
    waiting_ms: Optional[int] = None       # absent: `for T`
    next_id: Optional[int] = FINAL
    sticky: bool = False                   # `every`-armed entry
    partner_id: Optional[int] = None       # logical pair
    partner_op: Optional[str] = None       # "and" | "or"
    is_entry: bool = False


class PM:
    """Partial match (reference: StateEvent + pending-list membership)."""
    _ids = itertools.count()

    __slots__ = ("captures", "first_ts", "nodes", "deadlines", "filled",
                 "alive", "uid", "armed_ts", "sticky_at")

    def __init__(self):
        self.captures: dict = {}          # ref -> [Event]
        self.first_ts: Optional[int] = None
        self.nodes: set = set()           # node ids where pending
        self.deadlines: dict = {}         # node id -> ms (absent)
        self.filled: dict = {}            # node id -> bool (logical)
        self.alive = True
        self.uid = next(PM._ids)
        self.armed_ts: Optional[int] = None
        # node ids where THIS pm is the standing `every` arm: on match it
        # clones forward and stays (a clone is an ordinary pm again)
        self.sticky_at: set = set()

    def clone(self) -> "PM":
        p = PM()
        p.captures = {k: list(v) for k, v in self.captures.items()}
        p.first_ts = self.first_ts
        p.nodes = set()
        p.deadlines = dict(self.deadlines)
        p.filled = dict(self.filled)
        p.armed_ts = self.armed_ts
        return p

    def state(self) -> dict:
        return {"captures": {k: [(e.timestamp, e.data) for e in v]
                             for k, v in self.captures.items()},
                "first_ts": self.first_ts, "nodes": sorted(self.nodes),
                "deadlines": dict(self.deadlines),
                "filled": dict(self.filled),
                "armed_ts": self.armed_ts,
                "sticky_at": sorted(self.sticky_at)}

    @classmethod
    def from_state(cls, st: dict) -> "PM":
        p = cls()
        p.captures = {k: [Event(t, tuple(d)) for t, d in v]
                      for k, v in st["captures"].items()}
        p.first_ts = st["first_ts"]
        p.nodes = set(st["nodes"])
        p.deadlines = {int(k): v for k, v in st["deadlines"].items()}
        p.filled = {int(k): v for k, v in st["filled"].items()}
        p.armed_ts = st["armed_ts"]
        p.sticky_at = set(st.get("sticky_at", ()))
        return p


class NFACompiler:
    def __init__(self):
        self.nodes: list[Node] = []
        self._anon = itertools.count()

    def _new_node(self, stream: ast.SingleInputStream, kind: str = "stream",
                  waiting_ms=None) -> Node:
        ref = stream.ref_id or f"_s{next(self._anon)}"
        n = Node(id=len(self.nodes), stream_id=stream.stream_id, ref=ref,
                 filter_fn=None, kind=kind, waiting_ms=waiting_ms)
        self.nodes.append(n)
        return n

    def lower(self, elem: ast.StateElement, within: Optional[int] = None
              ) -> tuple[list[Node], list[Node]]:
        """Returns (entry_nodes, exit_nodes)."""
        if isinstance(elem, ast.StreamStateElement):
            n = self._new_node(elem.stream)
            n.within_ms = _min_ms(within, elem.within)
            return [n], [n]
        if isinstance(elem, ast.AbsentStreamStateElement):
            n = self._new_node(elem.stream, kind="absent",
                               waiting_ms=elem.waiting_time.millis
                               if elem.waiting_time else None)
            n.within_ms = _min_ms(within, elem.within)
            return [n], [n]
        if isinstance(elem, ast.CountStateElement):
            n = self._new_node(elem.stream.stream)
            n.min_count = elem.min_count
            n.max_count = elem.max_count if elem.max_count != ast.CountStateElement.ANY \
                else 10**9
            n.within_ms = _min_ms(within, elem.within)
            return [n], [n]
        if isinstance(elem, ast.LogicalStateElement):
            ln = self._lower_logical_side(elem.left)
            rn = self._lower_logical_side(elem.right)
            ln.partner_id, rn.partner_id = rn.id, ln.id
            ln.partner_op = rn.partner_op = elem.op
            w = _min_ms(within, elem.within)
            ln.within_ms = rn.within_ms = w
            return [ln, rn], [ln, rn]
        if isinstance(elem, ast.NextStateElement):
            e1, x1 = self.lower(elem.state, within)
            e2, x2 = self.lower(elem.next, within)
            for x in x1:
                x.next_id = e2[0].id   # logical pairs register both (see advance)
            return e1, x2
        if isinstance(elem, ast.EveryStateElement):
            w = _min_ms(within, elem.within)
            e, x = self.lower(elem.state, w)
            for n in e:
                n.sticky = True
            return e, x
        raise PlanError(f"cannot lower state element {type(elem).__name__}")

    def _lower_logical_side(self, side: ast.StateElement) -> Node:
        if isinstance(side, ast.StreamStateElement):
            return self._new_node(side.stream)
        if isinstance(side, ast.AbsentStreamStateElement):
            return self._new_node(side.stream, kind="absent",
                                  waiting_ms=side.waiting_time.millis
                                  if side.waiting_time else None)
        raise PlanError("logical and/or sides must be simple stream states")


def _min_ms(a: Optional[int], b) -> Optional[int]:
    bm = b.millis if isinstance(b, ast.TimeConstant) else b
    if a is None:
        return bm
    if bm is None:
        return a
    return min(a, bm)


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------

class PatternMatcher:
    def __init__(self, nodes: list[Node], entry_ids: list[int],
                 is_sequence: bool, query_within_ms: Optional[int]):
        self.nodes = nodes
        self.entry_ids = entry_ids
        self.is_sequence = is_sequence
        self.query_within = query_within_ms
        self.pendings: dict = {n.id: [] for n in nodes}
        self.by_stream: dict = {}
        for n in nodes:
            self.by_stream.setdefault(n.stream_id, []).append(n)
        self.started = False
        self._schema_names: dict = {}   # stream_id -> attr names (set by plan)
        self._names_by_ref: Optional[dict] = None   # lazy ref -> attr names

    # -- lifecycle ----------------------------------------------------------

    def start(self, now_ms: int) -> None:
        if self.started:
            return
        self.started = True
        pm = PM()
        pm.armed_ts = now_ms
        for nid in self.entry_ids:
            self._register(pm, nid, now_ms)
        # logical entry pairs share one PM; counts with min 0 epsilon-advance
        self._commit_epsilons(pm, now_ms)

    def _register(self, pm: PM, nid: int, now_ms: int) -> None:
        node = self.nodes[nid]
        if pm not in self.pendings[nid]:
            self.pendings[nid].append(pm)
        if nid not in pm.nodes and node.sticky:
            # entering an `every` scope from outside: become its standing arm
            pm.sticky_at.add(nid)
        pm.nodes.add(nid)
        if node.kind == "absent" and node.waiting_ms is not None \
                and nid not in pm.deadlines:
            base = pm.first_ts if pm.first_ts is not None else \
                (pm.armed_ts if pm.armed_ts is not None else now_ms)
            last = self._last_capture_ts(pm)
            base = last if last is not None else base
            pm.deadlines[nid] = base + node.waiting_ms

    def _last_capture_ts(self, pm: PM) -> Optional[int]:
        best = None
        for evs in pm.captures.values():
            for e in evs:
                if best is None or e.timestamp > best:
                    best = e.timestamp
        return best

    def _commit_epsilons(self, pm: PM, now_ms: int) -> None:
        """count nodes with min 0 also arm their successor immediately
        (cascades through consecutive optional states)."""
        changed = True
        while changed:
            changed = False
            for nid in list(pm.nodes):
                node = self.nodes[nid]
                if node.min_count == 0 and node.next_id is not FINAL \
                        and node.next_id not in pm.nodes:
                    self._register(pm, node.next_id, now_ms)
                    nxt = self.nodes[node.next_id]
                    if nxt.partner_id is not None:
                        self._register(pm, nxt.partner_id, now_ms)
                    changed = True

    # -- event processing ---------------------------------------------------

    def on_event(self, stream_id: str, ev: Event) -> list[dict]:
        """Returns completed matches as capture dicts."""
        matches: list = []
        staged: list = []          # (pm, node_id) to register after the event
        transitioned: set = set()  # pm uids that advanced/collected

        for node in self.by_stream.get(stream_id, ()):
            for pm in list(self.pendings[node.id]):
                if not pm.alive or node.id not in pm.nodes:
                    self.pendings[node.id].remove(pm)
                    continue
                # within expiry (lazy)
                if self._expired(pm, node, ev.timestamp):
                    self._kill(pm)
                    continue
                if node.kind == "absent":
                    if self._eval(node, pm, ev):
                        self._absent_stream_arrived(pm, node, matches, ev)
                    continue
                if self._eval(node, pm, ev):
                    self._transition(pm, node, ev, staged, matches, transitioned)

        # commit staged registrations
        for pm, nid in staged:
            if pm.alive:
                self._register(pm, nid, ev.timestamp)
                self._commit_epsilons(pm, ev.timestamp)

        # sequence strictness: ANY event in the query's stream set breaks
        # contiguity for every started PM that didn't transition on it
        if self.is_sequence:
            for lst in self.pendings.values():
                for pm in list(lst):
                    if pm.alive and pm.first_ts is not None \
                            and pm.uid not in transitioned:
                        self._kill(pm)
        self._gc()
        return matches

    def _expired(self, pm: PM, node: Node, now_ms: int) -> bool:
        if pm.first_ts is None:
            return False
        w = node.within_ms if node.within_ms is not None else self.query_within
        if w is None:
            return False
        return now_ms - pm.first_ts > w

    def _eval(self, node: Node, pm: PM, ev: Event) -> bool:
        if node.filter_fn is None:
            return True
        env = self.env_of_captures(pm.captures)
        # current event bound to the node's own ref (and unqualified attrs)
        for k, v in self._event_env(node, ev).items():
            env[k] = v
        return bool(node.filter_fn(env))

    def _event_env(self, node: Node, ev: Event) -> dict:
        env = {"__timestamp__": ev.timestamp}
        names = self._schema_names[node.stream_id]
        for nm, v in zip(names, ev.data):
            env[nm] = v
            env[f"{node.ref}.{nm}"] = v
        env[f"{node.ref}.__present__"] = True
        return env

    def env_of_captures(self, captures: dict) -> dict:
        names_by_ref = self._names_by_ref
        if names_by_ref is None:
            names_by_ref = self._names_by_ref = {
                n.ref: self._schema_names[n.stream_id] for n in self.nodes}
        env: dict = {}
        for ref, evs in captures.items():
            names = names_by_ref.get(ref, ())
            if not evs:
                continue
            last = evs[-1]
            env[f"{ref}.__present__"] = True
            for nm, v in zip(names, last.data):
                env[f"{ref}.{nm}"] = v
                env[f"{ref}[last].{nm}"] = v
            for i, e in enumerate(evs):
                for nm, v in zip(names, e.data):
                    env[f"{ref}[{i}].{nm}"] = v
            if len(evs) >= 2:
                for nm, v in zip(names, evs[-2].data):
                    env[f"{ref}[last-1].{nm}"] = v
        return env

    def _transition(self, pm: PM, node: Node, ev: Event, staged: list,
                    matches: list, transitioned: set) -> None:
        # standing `every` arms clone; the armed original never leaves
        if node.id in pm.sticky_at:
            work = pm.clone()
            # a fresh clone is pending at the same node (non-sticky semantics);
            # logical pairs pend at BOTH partners so the other side can fill
            # (reference: both Pre processors share the pending StateEvent)
            work.nodes.add(node.id)
            self.pendings[node.id].append(work)
            if node.partner_id is not None:
                work.nodes.add(node.partner_id)
                self.pendings[node.partner_id].append(work)
            work_is_clone = True
        else:
            work = pm
            work_is_clone = False
        transitioned.add(pm.uid)
        transitioned.add(work.uid)

        work.captures.setdefault(node.ref, []).append(ev)
        if work.first_ts is None:
            work.first_ts = ev.timestamp

        if node.partner_id is not None:
            self._logical_fill(work, node, ev, staged, matches)
        elif node.max_count > 1 or node.min_count != 1:
            n = len(work.captures[node.ref])
            if n >= node.max_count:
                self._leave(work, node.id)
            if n == node.min_count:
                self._advance(work, node, ev, staged, matches)
            elif n > node.min_count and node.next_id is FINAL:
                self._emit_or_stage(work, node, ev, staged, matches)
        else:
            self._leave(work, node.id)
            self._advance(work, node, ev, staged, matches)

        if work_is_clone and node.min_count == 0:
            pass  # epsilon successors handled at registration

    def _logical_fill(self, pm: PM, node: Node, ev: Event, staged, matches):
        pm.filled[node.id] = True
        partner = self.nodes[node.partner_id]
        if node.partner_op == "or":
            done = True
        elif partner.kind == "absent":
            # `not B and e2=C`: if B had arrived this PM would be dead, so
            # the present side completing the pair suffices
            done = True
        else:
            done = pm.filled.get(node.partner_id, False)
        if done:
            self._leave(pm, node.id)
            self._leave(pm, node.partner_id)
            self._advance(pm, node, ev, staged, matches)

    def _advance(self, pm: PM, node: Node, ev: Event, staged, matches):
        if node.next_id is FINAL:
            self._emit_or_stage(pm, node, ev, staged, matches)
            return
        nxt = self.nodes[node.next_id]
        staged.append((pm, nxt.id))
        if nxt.partner_id is not None:
            staged.append((pm, nxt.partner_id))

    def _emit_or_stage(self, pm: PM, node: Node, ev: Event, staged, matches):
        if self.query_within is not None and pm.first_ts is not None \
                and ev.timestamp - pm.first_ts > self.query_within:
            self._kill(pm)
            return
        matches.append({"captures": {k: list(v) for k, v in pm.captures.items()},
                        "ts": ev.timestamp})
        # count-final PMs may continue collecting (still pending at count node)
        if not any(self.nodes[nid].max_count > 1 for nid in pm.nodes):
            self._kill(pm)

    def _absent_stream_arrived(self, pm: PM, node: Node, matches, ev):
        """The forbidden stream fired for a pending absent node."""
        if node.partner_id is not None and node.partner_op == "or":
            self._leave(pm, node.id)
            return
        if node.partner_id is not None:  # and-with-absent: whole pm dies
            self._kill(pm)
            return
        if node.id in pm.sticky_at:
            # every not-X: re-arm deadline after the offending event
            pm.deadlines[node.id] = ev.timestamp + (node.waiting_ms or 0)
            return
        self._kill(pm)

    # -- timers (absent states) ---------------------------------------------

    def on_timer(self, now_ms: int) -> list[dict]:
        matches: list = []
        staged: list = []
        for node in self.nodes:
            if node.kind != "absent":
                continue
            for pm in list(self.pendings[node.id]):
                if not pm.alive:
                    self.pendings[node.id].remove(pm)
                    continue
                dl = pm.deadlines.get(node.id)
                if dl is None or now_ms < dl:
                    continue
                # waiting period elapsed with no forbidden event
                if node.id in pm.sticky_at:
                    work = pm.clone()
                    pm.deadlines[node.id] = dl + (node.waiting_ms or 1)
                else:
                    work = pm
                    self._leave(work, node.id)
                    if node.partner_id is not None:
                        self._leave(work, node.partner_id)
                if work.first_ts is None:
                    work.first_ts = dl
                if node.next_id is FINAL:
                    matches.append({"captures": {k: list(v) for k, v
                                                 in work.captures.items()},
                                    "ts": dl})
                    if work is pm and not node.sticky:
                        self._kill(work)
                else:
                    staged.append((work, node.next_id))
        for pm, nid in staged:
            if pm.alive:
                self._register(pm, nid, now_ms)
                self._commit_epsilons(pm, now_ms)
        self._gc()
        return matches

    def next_wakeup(self) -> Optional[int]:
        best = None
        for node in self.nodes:
            if node.kind != "absent":
                continue
            for pm in self.pendings[node.id]:
                if not pm.alive:
                    continue
                dl = pm.deadlines.get(node.id)
                if dl is not None and (best is None or dl < best):
                    best = dl
        return best

    # -- bookkeeping ---------------------------------------------------------

    def _leave(self, pm: PM, nid: int) -> None:
        pm.nodes.discard(nid)
        try:
            self.pendings[nid].remove(pm)
        except ValueError:
            pass

    def _kill(self, pm: PM) -> None:
        pm.alive = False
        for nid in list(pm.nodes):
            self._leave(pm, nid)

    def _gc(self) -> None:
        for lst in self.pendings.values():
            lst[:] = [p for p in lst if p.alive]

    # -- snapshot ------------------------------------------------------------

    def state(self) -> dict:
        pms: dict = {}
        order: dict = {}
        for nid, lst in self.pendings.items():
            order[nid] = []
            for pm in lst:
                pms[pm.uid] = pm
                order[nid].append(pm.uid)
        return {"pms": {uid: pm.state() for uid, pm in pms.items()},
                "order": order, "started": self.started}

    def restore(self, st: dict) -> None:
        rebuilt = {int(uid): PM.from_state(s) for uid, s in st["pms"].items()}
        self.pendings = {n.id: [] for n in self.nodes}
        for nid, uids in st["order"].items():
            for uid in uids:
                self.pendings[int(nid)].append(rebuilt[int(uid)])
        self.started = st["started"]


def collect_filters(elem) -> list:
    """Filters per lowered node, in the same order NFACompiler.lower
    creates nodes (depends on tree shape)."""
    out: list = []

    def walk(e):
        if isinstance(e, ast.StreamStateElement):
            out.append(e.stream.filters)
        elif isinstance(e, ast.AbsentStreamStateElement):
            out.append(e.stream.filters)
        elif isinstance(e, ast.CountStateElement):
            out.append(e.stream.stream.filters)
        elif isinstance(e, ast.LogicalStateElement):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, ast.NextStateElement):
            walk(e.state)
            walk(e.next)
        elif isinstance(e, ast.EveryStateElement):
            walk(e.state)
        else:
            raise PlanError(f"unknown state element {type(e).__name__}")

    walk(elem)
    return out
