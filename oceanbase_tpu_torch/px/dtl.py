"""DTL-style cross-node compute pushdown: ship plans, not tables.

Reference analog: the PX framework shipping DFOs to the servers that own
the data and moving only exchange rows over DTL
(src/sql/dtl/ob_dtl_rpc_channel.h:39, ob_px_sqc_handler.h — the SQC
executes its DFO against local tablets and streams result rows back).
Our multi-node cluster previously did the opposite: remote-relation
access pulled the *entire snapshot* to the coordinator (`das.scan`
paging in net/node.py) before executing.  This module inverts that for
qualifying subtrees:

- the coordinator splits a single-table scan/filter/project subtree —
  optionally under a GroupBy/ScalarAgg decomposed via
  ``dist_ops.split_aggs`` — into a *remote partial plan* and a *local
  final-merge plan*;
- the partial plan is serialized (JSON-able node encoding riding the
  existing codec) to every node of the cluster, each executing it over a
  disjoint primary-key-hash slice of its local replica at one snapshot
  through the ordinary ``exec/plan.py::execute_plan``;
- only the filtered projection / partial aggregate state returns over
  the wire for the final merge — bytes on wire shrink from O(table) to
  O(result).

Unsupported shapes, lagging replicas, and node failures fall back:
per-slice to local execution on the coordinator (it holds a replica),
whole-query to the ordinary serial path.

Port of ``oceanbase_tpu/px/dtl.py``: the same plan and expression codec
(the JSON of a plan is equal in both packages; no torch dtype or device
reaches a message), the same qualification, slicing, reply digest and
merge.  A fragment runs through the port's ``execute_plan`` on the
node's device (``cuda`` unless the node was started with ``--device
cpu``), and so does the coordinator's final merge.  A fragment ships
its device time back as the difference of ``exec_times`` taken after
its result read, once its CUDA event pair has been resolved.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from oceanbase_tpu_torch.datatypes import SqlType, TypeKind
from oceanbase_tpu_torch.exec import plan as pp
from oceanbase_tpu_torch.exec.diag import CapacityOverflow
from oceanbase_tpu_torch.exec.ops import AggSpec
from oceanbase_tpu_torch.exec.plan import execute_plan
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.px.dist_ops import split_aggs
from oceanbase_tpu_torch.server import metrics as qmetrics
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.vector import Relation, from_numpy, to_numpy

# exchange accounting (host side, recorded at DtlMetrics.record — the
# same result boundary the gv$px_exchange ring observes)
qmetrics.declare("dtl.exchanges", "counter",
                 "exchange events (pushdown fan-outs + legacy pulls)")
qmetrics.declare("dtl.bytes_shipped", "counter",
                 "wire bytes moved by the exchange")
qmetrics.declare("dtl.rows_shipped", "counter",
                 "exchange rows crossing the wire")
qmetrics.declare("dtl.slices", "counter",
                 "partial-plan slices executed (local + remote)")
qmetrics.declare("dtl.fallback_parts", "counter",
                 "slices re-run locally AFTER a peer failure")
qmetrics.declare("dtl.avoided_parts", "counter",
                 "slices routed locally pre-emptively (unhealthy peer)")
qmetrics.declare("dtl.exchange_s", "histogram",
                 "whole-exchange wall time", unit="s")
qmetrics.declare("dtl.slice_skew", "histogram",
                 "max/mean output rows across one exchange's slices "
                 "(1.0 = perfectly balanced; partition skew the CBO "
                 "must price around)")
qmetrics.declare("dtl.digest_mismatches", "counter",
                 "exchange replies whose payload digest failed on the "
                 "coordinator (slice re-ran locally — never merged)")

#: name of the coordinator-side relation holding the merged exchange rows
DTL_TABLE = "__dtl_recv__"


qmetrics.declare("dtl.cancels", "counter",
                 "dtl.cancel flags observed (sent or received)")


class NotPushable(Exception):
    """Plan/expr shape the DTL wire codec does not cover."""


class CancelRegistry:
    """Per-node registry of in-flight fragment cancel flags, keyed by
    the coordinator's statement token (StmtCtx.token).

    ``dtl.cancel`` is IDEMPOTENT: cancelling an unknown token plants a
    tombstone (the flag, pre-set), so a fragment racing in later — or a
    resent cancel after a lost reply — converges on the same state.
    Bounded LRU so tombstones of statements that never arrive cannot
    grow the map without bound."""

    MAX_ENTRIES = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, threading.Event]" \
            = collections.OrderedDict()
        #: token -> in-flight fragment count; pinned entries are never
        #: LRU-evicted (evicting a live Event means dtl.cancel plants a
        #: NEW one and the running fragment never observes KILL)
        self._pins: dict[str, int] = {}

    def entry(self, token: str) -> threading.Event:
        """The cancel flag for ``token`` (created unset on first use)."""
        with self._lock:
            ev = self._entries.get(token)
            if ev is None:
                if len(self._entries) >= self.MAX_ENTRIES:
                    self._evict_locked()
                ev = self._entries[token] = threading.Event()
            else:
                self._entries.move_to_end(token)
            return ev

    def _evict_locked(self):
        """Drop unpinned entries (tombstones / idle flags), oldest
        first, until under capacity.  When every entry is pinned the map
        grows past MAX_ENTRIES instead — correctness over the bound."""
        excess = len(self._entries) - self.MAX_ENTRIES + 1
        if excess <= 0:
            return
        for tok in [t for t in self._entries if t not in self._pins]:
            del self._entries[tok]
            excess -= 1
            if excess <= 0:
                break

    def pin(self, token: str) -> threading.Event:
        """Mark ``token``'s flag in-flight (re-entrant: one count per
        executing fragment); the entry survives LRU until unpinned."""
        with self._lock:
            ev = self._entries.get(token)
            if ev is None:
                if len(self._entries) >= self.MAX_ENTRIES:
                    self._evict_locked()
                ev = self._entries[token] = threading.Event()
            else:
                self._entries.move_to_end(token)
            self._pins[token] = self._pins.get(token, 0) + 1
            return ev

    def unpin(self, token: str):
        with self._lock:
            n = self._pins.get(token, 0) - 1
            if n > 0:
                self._pins[token] = n
            else:
                self._pins.pop(token, None)

    def cancel(self, token: str) -> bool:
        """Set the flag (planting it if unknown).  -> was it already
        set?  Re-application is a no-op — the verb's idempotence."""
        ev = self.entry(token)
        already = ev.is_set()
        ev.set()
        qmetrics.inc("dtl.cancels")
        return already


class DtlLagging(RuntimeError):
    """Replica has not applied up to the requested snapshot."""


# ---------------------------------------------------------------------------
# expression / plan wire codec (≙ OB_UNIS serialization of ObExpr/ObOpSpec;
# JSON-able dicts so the frames ride net/codec.py unchanged)
# ---------------------------------------------------------------------------


def _enc_type(t: SqlType | None):
    if t is None:
        return None
    return [t.kind.value, t.precision or 0, t.scale or 0]


def _dec_type(v) -> SqlType | None:
    if v is None:
        return None
    return SqlType(TypeKind(v[0]), v[1], v[2])


def encode_expr(e: ir.Expr):
    if isinstance(e, ir.ColumnRef):
        return {"e": "col", "name": e.name}
    if isinstance(e, ir.Literal):
        v = e.value
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        if v is not None and not isinstance(v, (int, float, str, bool)):
            raise NotPushable(f"literal {type(v).__name__}")
        return {"e": "lit", "v": v, "t": _enc_type(e.dtype)}
    if isinstance(e, ir.Arith):
        return {"e": "arith", "op": e.op, "l": encode_expr(e.left),
                "r": encode_expr(e.right)}
    if isinstance(e, ir.Cmp):
        return {"e": "cmp", "op": e.op, "l": encode_expr(e.left),
                "r": encode_expr(e.right)}
    if isinstance(e, ir.Logic):
        return {"e": "logic", "op": e.op,
                "args": [encode_expr(a) for a in e.args]}
    if isinstance(e, ir.Not):
        return {"e": "not", "a": encode_expr(e.arg)}
    if isinstance(e, ir.InList):
        vs = []
        for v in e.values:
            if isinstance(v, ir.Literal):
                vs.append({"l": encode_expr(v)})
            elif v is None or isinstance(v, (int, float, str, bool)):
                vs.append(v)
            else:
                raise NotPushable("in-list value")
        return {"e": "in", "a": encode_expr(e.arg), "vs": vs,
                "neg": bool(e.negated)}
    if isinstance(e, ir.Like):
        return {"e": "like", "a": encode_expr(e.arg), "p": e.pattern,
                "neg": bool(e.negated)}
    if isinstance(e, ir.IsNull):
        return {"e": "isnull", "a": encode_expr(e.arg),
                "neg": bool(e.negated)}
    if isinstance(e, ir.Case):
        return {"e": "case",
                "whens": [[encode_expr(c), encode_expr(v)]
                          for c, v in e.whens],
                "else": (encode_expr(e.else_)
                         if e.else_ is not None else None)}
    if isinstance(e, ir.Cast):
        return {"e": "cast", "a": encode_expr(e.arg),
                "t": _enc_type(e.dtype)}
    if isinstance(e, ir.FuncCall):
        return {"e": "func", "name": e.name,
                "args": [encode_expr(a) for a in e.args]}
    raise NotPushable(type(e).__name__)


def decode_expr(d) -> ir.Expr:
    k = d["e"]
    if k == "col":
        return ir.ColumnRef(d["name"])
    if k == "lit":
        return ir.Literal(d["v"], _dec_type(d.get("t")))
    if k == "arith":
        return ir.Arith(d["op"], decode_expr(d["l"]), decode_expr(d["r"]))
    if k == "cmp":
        return ir.Cmp(d["op"], decode_expr(d["l"]), decode_expr(d["r"]))
    if k == "logic":
        return ir.Logic(d["op"], [decode_expr(a) for a in d["args"]])
    if k == "not":
        return ir.Not(decode_expr(d["a"]))
    if k == "in":
        vs = [decode_expr(v["l"]) if isinstance(v, dict) else v
              for v in d["vs"]]
        return ir.InList(decode_expr(d["a"]), vs,
                         negated=bool(d["neg"]))
    if k == "like":
        return ir.Like(decode_expr(d["a"]), d["p"], negated=bool(d["neg"]))
    if k == "isnull":
        return ir.IsNull(decode_expr(d["a"]), negated=bool(d["neg"]))
    if k == "case":
        return ir.Case([(decode_expr(c), decode_expr(v))
                        for c, v in d["whens"]],
                       decode_expr(d["else"])
                       if d.get("else") is not None else None)
    if k == "cast":
        return ir.Cast(decode_expr(d["a"]), _dec_type(d["t"]))
    if k == "func":
        return ir.FuncCall(d["name"], [decode_expr(a) for a in d["args"]])
    raise NotPushable(f"expr tag {k!r}")


def _enc_aggs(aggs):
    out = []
    for a in aggs:
        if a.fn == "count_distinct" or getattr(a, "distinct", False):
            raise NotPushable("count_distinct")
        out.append([a.name, a.fn,
                    encode_expr(a.arg) if a.arg is not None else None])
    return out


def _dec_aggs(items):
    return [AggSpec(n, fn, decode_expr(a) if a is not None else None)
            for n, fn, a in items]


def encode_plan(node: pp.PlanNode):
    if isinstance(node, pp.TableScan):
        return {"p": "scan", "table": node.table,
                "columns": list(node.columns) if node.columns else None,
                "rename": dict(node.rename) if node.rename else None}
    if isinstance(node, pp.Filter):
        return {"p": "filter", "child": encode_plan(node.child),
                "pred": encode_expr(node.pred)}
    if isinstance(node, pp.Project):
        return {"p": "project", "child": encode_plan(node.child),
                "outputs": {n: encode_expr(e)
                            for n, e in node.outputs.items()}}
    if isinstance(node, pp.Compact):
        return {"p": "compact", "child": encode_plan(node.child),
                "cap": node.capacity, "strict": node.strict}
    if isinstance(node, pp.GroupBy):
        return {"p": "groupby", "child": encode_plan(node.child),
                "keys": {n: encode_expr(e) for n, e in node.keys.items()},
                "aggs": _enc_aggs(node.aggs), "cap": node.out_capacity}
    if isinstance(node, pp.ScalarAgg):
        return {"p": "scalaragg", "child": encode_plan(node.child),
                "aggs": _enc_aggs(node.aggs)}
    raise NotPushable(type(node).__name__)


def decode_plan(d) -> pp.PlanNode:
    k = d["p"]
    if k == "scan":
        return pp.TableScan(d["table"],
                            columns=list(d["columns"])
                            if d.get("columns") else None,
                            rename=dict(d["rename"])
                            if d.get("rename") else None)
    if k == "filter":
        return pp.Filter(decode_plan(d["child"]), decode_expr(d["pred"]))
    if k == "project":
        return pp.Project(decode_plan(d["child"]),
                          {n: decode_expr(e)
                           for n, e in d["outputs"].items()})
    if k == "compact":
        return pp.Compact(decode_plan(d["child"]), d.get("cap"),
                          strict=bool(d.get("strict", False)))
    if k == "groupby":
        return pp.GroupBy(decode_plan(d["child"]),
                          {n: decode_expr(e)
                           for n, e in d["keys"].items()},
                          _dec_aggs(d["aggs"]), out_capacity=d.get("cap"))
    if k == "scalaragg":
        return pp.ScalarAgg(decode_plan(d["child"]), _dec_aggs(d["aggs"]))
    raise NotPushable(f"plan tag {k!r}")


# ---------------------------------------------------------------------------
# pushdown qualification + partial/final split (≙ ObDfoMgr splitting at the
# exchange boundary; the partial/final aggregate rewrite is split_aggs)
# ---------------------------------------------------------------------------


_SIMPLE = (pp.TableScan, pp.Filter, pp.Project, pp.Compact)


def _is_simple_chain(node) -> bool:
    if not isinstance(node, _SIMPLE):
        return False
    return all(_is_simple_chain(c) for c in node.children())


def _count_scans(node) -> int:
    n = 1 if isinstance(node, pp.TableScan) else 0
    return n + sum(_count_scans(c) for c in node.children())


def _find_scan(node) -> pp.TableScan:
    if isinstance(node, pp.TableScan):
        return node
    for c in node.children():
        s = _find_scan(c)
        if s is not None:
            return s
    return None


def _has_filter(node) -> bool:
    if isinstance(node, pp.Filter):
        return True
    return any(_has_filter(c) for c in node.children())


def _replace(node, target, repl):
    """Rebuild ``node`` with the (identity-matched) ``target`` subtree
    swapped for ``repl``."""
    import dataclasses

    if node is target:
        return repl
    fields = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, pp.PlanNode):
            nv = _replace(v, target, repl)
            fields[f.name] = nv
            changed = changed or nv is not v
        elif f.name == "inputs" and isinstance(v, list):
            nv = [_replace(c, target, repl) for c in v]
            fields[f.name] = nv
            changed = changed or any(a is not b for a, b in zip(nv, v))
    if not changed:
        return node
    return dataclasses.replace(node, **fields)


@dataclass
class PushPlan:
    """One qualifying pushdown: the remote partial plan (shipped), the
    rebuilt coordinator plan reading the merged exchange relation, and
    the scanned base table."""

    table: str
    remote: pp.PlanNode
    rebuilt: pp.PlanNode
    encoded: dict
    has_agg: bool


def split_pushdown(plan: pp.PlanNode) -> PushPlan | None:
    """-> PushPlan when a single-table scan/filter/project subtree
    (optionally under a decomposable GroupBy/ScalarAgg) can execute on
    the data nodes; None otherwise (caller keeps the serial path)."""
    if len(pp.referenced_tables(plan)) != 1 or _count_scans(plan) != 1:
        return None
    node = plan
    target = None
    is_agg = False
    while True:
        if isinstance(node, (pp.GroupBy, pp.ScalarAgg)) and \
                _is_simple_chain(node.child):
            target, is_agg = node, True
            break
        if _is_simple_chain(node):
            target = node
            break
        kids = node.children()
        if len(kids) != 1:
            return None
        node = kids[0]
    if not is_agg and not _has_filter(target):
        # an unfiltered, un-aggregated subtree would ship the whole
        # table — no better than the snapshot pull it replaces
        return None
    scan = _find_scan(target)
    if scan is None:
        return None
    try:
        if is_agg:
            partial, final, post = split_aggs(target.aggs)
            # est_rows rides the constructed halves (metadata only —
            # fingerprints ignore it): the coordinator q-errors the
            # summed per-slice partial outputs against the original
            # node's estimate
            if isinstance(target, pp.GroupBy):
                remote = pp.GroupBy(target.child, target.keys, partial,
                                    out_capacity=target.out_capacity,
                                    est_rows=target.est_rows)
                merged = pp.GroupBy(
                    pp.TableScan(DTL_TABLE),
                    {k: ir.col(k) for k in target.keys}, final,
                    out_capacity=target.out_capacity,
                    est_rows=target.est_rows)
                outs = {k: ir.col(k) for k in target.keys}
                outs.update(post)
                repl = pp.Project(merged, outs,
                                  est_rows=target.est_rows)
            else:
                remote = pp.ScalarAgg(target.child, partial, est_rows=1)
                repl = pp.Project(
                    pp.ScalarAgg(pp.TableScan(DTL_TABLE), final,
                                 est_rows=1),
                    dict(post), est_rows=1)
        else:
            remote = target
            repl = pp.TableScan(DTL_TABLE)
        encoded = encode_plan(remote)
    except (NotPushable, NotImplementedError):
        return None
    rebuilt = _replace(plan, target, repl)
    return PushPlan(scan.table, remote, rebuilt, encoded, is_agg)


# ---------------------------------------------------------------------------
# data-node fragment execution (the SQC side)
# ---------------------------------------------------------------------------


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _col_hash(vals: np.ndarray) -> np.ndarray:
    if vals.dtype.kind in "iub":
        return _mix64(vals.astype(np.int64).astype(np.uint64))
    if vals.dtype.kind == "f":
        return _mix64(vals.astype(np.float64).view(np.uint64))
    import zlib

    return _mix64(np.fromiter(
        (zlib.crc32(str(v).encode("utf-8", "surrogatepass"))
         for v in vals), np.uint64, len(vals)))


def slice_mask(arrays: dict, key_cols, part: int, nparts: int):
    """Deterministic disjoint row slices by primary-key hash.

    Replicas may enumerate physically identical snapshots in different
    orders (freeze/flush timing is node-local), so positional slicing is
    unsound — hashing the key VALUES assigns every logical row to exactly
    one part on every replica."""
    n = len(next(iter(arrays.values()))) if arrays else 0
    if nparts <= 1:
        return np.ones(n, dtype=bool)
    h = np.zeros(n, dtype=np.uint64)
    for c in key_cols:
        h = _mix64(h ^ _col_hash(np.asarray(arrays[c])))
    return (h % np.uint64(nparts)).astype(np.int64) == part


def host_relation(arrays: dict, valids: dict, types: dict,
                  device=None) -> Relation:
    """Host columns -> a Relation on ``device`` padded onto the shared
    capacity-bucket ladder (the reference's capacities, so overflow
    retries fire in the same place) with a live-row mask."""
    from oceanbase_tpu_torch.vector import bucket_capacity

    n = len(next(iter(arrays.values()))) if arrays else 0
    rel = from_numpy(
        arrays, types=types,
        valids={k: v for k, v in valids.items() if v is not None},
        device=device)
    return rel.pad_to(bucket_capacity(n))


def execute_fragment(ts, plan_enc: dict, snapshot: int, part: int,
                     nparts: int, with_ops: bool = False,
                     monitor_lanes: bool = False, device=None) -> dict:
    """Run one partial-plan slice against a local tablet snapshot.

    -> {"arrays", "valids", "types", "rows", "scanned"[, "ops"]} — the
    wire shape of one DTL exchange reply (arrays are host numpy, riding
    the codec's binary buffer sections).  With ``with_ops`` the reply
    carries the slice's per-operator output rows in executor postorder
    as a bare int list (the coordinator derives op names and estimates
    from its own copy of the partial plan — ``spans``-style merge at a
    fraction of the wire cost).  ``monitor_lanes`` mirrors the
    coordinator's ``enable_sql_plan_monitor`` knob, as in the reference
    (whose monitored variant is part of its compile key).  The slice
    runs on ``device``: the host snapshot goes up, the reply's rows come
    back at the result read (``to_numpy``)."""
    remote = decode_plan(plan_enc)
    scan = _find_scan(remote)
    arrays, valids = ts.tablet.snapshot_arrays(snapshot)
    n = len(next(iter(arrays.values()))) if arrays else 0
    scanned = n
    if nparts > 1 and n:
        m = slice_mask(arrays, list(ts.tdef.primary_key), part, nparts)
        arrays = {k: np.asarray(v)[m] for k, v in arrays.items()}
        valids = {k: (np.asarray(v)[m] if v is not None else None)
                  for k, v in valids.items()}
        scanned = int(m.sum())
    rel = host_relation(arrays, valids,
                        {c.name: c.dtype for c in ts.tdef.columns},
                        device=device)
    mon = [] if (with_ops or monitor_lanes) else None
    # host/device split of THIS fragment, shipped back beside the
    # monitor rows so the coordinator's statement accounting covers the
    # cluster's device time, not just its own.  Measured as a DELTA of
    # the thread-local accumulator: a coordinator running a slice
    # locally (avoided/fallback parts) goes through here on its session
    # thread, whose statement totals must keep accumulating untouched.
    from oceanbase_tpu_torch.exec.plan import exec_times, resolve_pending

    before = exec_times()
    out = execute_plan(remote, {scan.table: rel}, monitor_out=mon,
                       monitor_collect=with_ops, op_spans=False)
    raw = to_numpy(out)
    # the result read above is the boundary after which this slice's
    # CUDA event pair has completed: resolve it (and the pinned monitor
    # counts) BEFORE the difference, or device_s would read 0 on the card
    resolve_pending(block=True)
    after = exec_times()
    # compact wire shape (bare int list, µs-quantized): the pushdown
    # reply's whole point is its tiny wire cost vs the snapshot pull —
    # a keyed float dict per slice would eat a visible slice of that
    # budget
    frag_times = [int((after.host_s - before.host_s) * 1e6),
                  int((after.device_s - before.device_s) * 1e6),
                  int(after.flops - before.flops),
                  int(after.bytes - before.bytes),
                  after.calls - before.calls]
    r_arrays = {k: v for k, v in raw.items()
                if not k.startswith("__valid__")}
    r_valids = {k[len("__valid__"):]: v for k, v in raw.items()
                if k.startswith("__valid__")}
    rows = len(next(iter(r_arrays.values()))) if r_arrays else 0
    from oceanbase_tpu_torch.storage.integrity import arrays_crc

    reply = {
        "arrays": r_arrays, "valids": r_valids,
        "types": {name: [c.dtype.kind.value, c.dtype.precision or 0,
                         c.dtype.scale or 0]
                  for name, c in out.columns.items()},
        "rows": rows, "scanned": scanned,
        # end-to-end payload digest: the coordinator re-hashes the
        # decoded reply before merging (verify_reply), so corruption
        # anywhere between this result boundary and the merge — wire,
        # codec, allocator — turns into a local re-run, never rows
        "crc": arrays_crc(r_arrays, r_valids),
        # [host_us, device_us, flops, bytes, calls] of this fragment
        "tm": frag_times,
    }
    if with_ops:
        reply["ops"] = [int(r["rows"]) for r in mon]
    return reply


def verify_reply(reply: dict, part: int, peer: int):
    """Coordinator-side digest check of one exchange reply.  Raises
    CorruptionError (triaged like a slice failure: the coordinator
    re-runs the slice on its own replica)."""
    from oceanbase_tpu_torch.storage.integrity import CorruptionError, arrays_crc

    crc = reply.get("crc")
    if crc is None:
        return  # pre-integrity peer build
    got = arrays_crc(reply.get("arrays", {}), reply.get("valids", {}))
    if got != crc:
        qmetrics.inc("dtl.digest_mismatches")
        raise CorruptionError(
            f"dtl reply digest mismatch (part {part}, peer {peer})",
            kind="dtl")


def merge_fragments(parts: list[dict], device=None) -> Relation:
    """Concatenate per-node exchange replies into the coordinator-side
    relation the rebuilt (final-merge) plan scans as ``DTL_TABLE``, on
    ``device``."""
    first = parts[0]
    names = list(first["arrays"])
    types = {n: _dec_type(first["types"][n]) for n in first["types"]}
    arrays, valids = {}, {}
    for c in names:
        chunks = [np.asarray(p["arrays"][c]) for p in parts]
        arrays[c] = np.concatenate(chunks) if chunks else np.zeros(0)
        if any(c in p.get("valids", {}) for p in parts):
            vs = []
            for p in parts:
                v = p.get("valids", {}).get(c)
                vs.append(np.asarray(v, dtype=bool) if v is not None
                          else np.ones(len(p["arrays"][c]), dtype=bool))
            valids[c] = np.concatenate(vs)
        if arrays[c].dtype == object:
            # decoded NULL strings arrive as None; the dictionary
            # encoder wants real strings (validity rides the mask)
            a = arrays[c]
            arrays[c] = np.array(["" if x is None else x for x in a],
                                 dtype=object)
    return host_relation(arrays, valids, types, device=device)


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


@dataclass
class DtlRecord:
    """One exchange event (pushdown or legacy snapshot pull) — the row
    shape of gv$px_exchange."""

    ts: float
    table: str
    mode: str                  # "pushdown" | "pull"
    parts: int
    pushdown_hit: bool
    bytes_shipped: int
    rows_shipped: int
    fallback_parts: int = 0    # slices re-run locally AFTER a failure
    avoided_parts: int = 0     # slices routed locally PRE-EMPTIVELY
    elapsed_s: float = 0.0
    remote_device_s: float = 0.0  # summed device_s shipped by remote
    #                             # fragments (exec/plan.py split)
    # per-slice attribution (index = part number): output rows, wire
    # bytes (0 for locally-run slices) and wall seconds per slice —
    # partition skew made visible before the CBO has to price it
    slice_rows: list = field(default_factory=list)
    slice_bytes: list = field(default_factory=list)
    slice_elapsed: list = field(default_factory=list)

    @property
    def slice_skew(self) -> float:
        """max/mean output rows across slices (0.0 = no slice data)."""
        if not self.slice_rows:
            return 0.0
        mean = sum(self.slice_rows) / len(self.slice_rows)
        return (max(self.slice_rows) / mean) if mean > 0 else 0.0


class DtlMetrics:
    """Ring of recent exchange events + cumulative totals (thread-safe;
    ≙ the DTL channel stats feeding gv$px_dtl_intermediate_*)."""

    def __init__(self, capacity: int = 2000):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.total_rows = 0
        self.pushdown_hits = 0
        self.pulls = 0

    def record(self, rec: DtlRecord):
        with self._lock:
            self._ring.append(rec)
            self.total_bytes += rec.bytes_shipped
            self.total_rows += rec.rows_shipped
            if rec.pushdown_hit:
                self.pushdown_hits += 1
            else:
                self.pulls += 1
        qmetrics.inc("dtl.exchanges", mode=rec.mode)
        qmetrics.inc("dtl.bytes_shipped", rec.bytes_shipped, mode=rec.mode)
        qmetrics.inc("dtl.rows_shipped", rec.rows_shipped, mode=rec.mode)
        qmetrics.inc("dtl.slices", rec.parts, mode=rec.mode)
        if rec.fallback_parts:
            qmetrics.inc("dtl.fallback_parts", rec.fallback_parts)
        if rec.avoided_parts:
            qmetrics.inc("dtl.avoided_parts", rec.avoided_parts)
        qmetrics.observe("dtl.exchange_s", rec.elapsed_s, mode=rec.mode)
        skew = rec.slice_skew
        if skew > 0.0:
            qmetrics.observe("dtl.slice_skew", skew)

    def recent(self, n: int = 100) -> list:
        with self._lock:
            return list(self._ring)[-n:]


# ---------------------------------------------------------------------------
# coordinator (the QC side)
# ---------------------------------------------------------------------------


class DtlExchange:
    """Per-node coordinator: qualifies a plan, fans the partial plan out
    to every cluster node (itself included), merges partial states, and
    runs the final plan locally.  Per-slice failures fall back to local
    execution — the coordinator holds a full replica."""

    def __init__(self, node, metrics: DtlMetrics | None = None):
        self.node = node
        self.metrics = metrics if metrics is not None else DtlMetrics()
        # dedicated data channels (≙ DTL channels living beside the rpc
        # control plane): fragment execution can take seconds, and
        # sharing the control-plane RpcClients' pools would queue PALF
        # heartbeats behind bulk replies
        self._chan: dict[int, object] = {}
        self._chan_lock = threading.Lock()

    def _channel(self, pid: int):
        from oceanbase_tpu_torch.net.rpc import RpcClient

        with self._chan_lock:
            cli = self._chan.get(pid)
            if cli is None:
                h, p = self.node.peer_addrs[pid]
                # share the node's fault plane and failure detector:
                # injected dtl.execute faults hit the data channels too,
                # and their outcomes feed the breaker like control
                # traffic does
                health = getattr(self.node, "health", None)
                cli = RpcClient(
                    h, p, timeout_s=60.0, peer_id=pid,
                    local_id=self.node.node_id,
                    faults=getattr(self.node, "faults", None),
                    observer=(health.observer(pid)
                              if health is not None else None))
                self._chan[pid] = cli
            return cli

    def try_execute(self, plan: pp.PlanNode, monitor: list | None = None,
                    collect: bool = True):
        """-> merged Relation, or None to fall back to the serial path.
        Raises CapacityOverflow (propagating a remote overflow) so the
        session's retry ladder re-plans with larger budgets.

        ``monitor`` non-None keeps the merge plan's monitored executable
        variant stable while ``collect`` (the session's per-plan sampling
        decision) gates the actual ledger work: per-op reply rows are
        only requested — and wire bytes only paid — on sampled runs."""
        node = self.node
        try:
            if not bool(node.config["enable_dtl_pushdown"]):
                return None
            min_rows = int(node.config["dtl_min_rows"])
        except KeyError:
            return None
        if not node.palf.is_leader:
            # weak reads land on followers precisely for LOCAL serving;
            # only the leader coordinates cross-node fan-out (≙ the QC
            # running where the query was planned)
            return None
        push = split_pushdown(plan)
        if push is None:
            return None
        ts = node.engine.tables.get(push.table)
        if ts is None or not ts.tdef.primary_key:
            return None
        if ts.tablet.row_count_estimate() < min_rows:
            return None
        peers = [(pid, self._channel(pid))
                 for pid in sorted(node.peer_addrs)]
        nparts = 1 + len(peers)
        if nparts < 2:
            return None
        # failure detector (net/health.py): slices owned by suspect /
        # down peers run locally FROM THE START — pre-emptive avoidance
        # instead of paying the rpc deadline and then falling back (≙
        # the PX scheduler consulting the server blacklist when it
        # places SQCs).  The hash slicing is node-independent, so WHO
        # executes a part never changes the result.
        health = getattr(node, "health", None)
        remote: list = []        # (part index, client) worth shipping
        avoided_parts: list = [0]  # part 0 is always the coordinator's
        for i, (pid, cli) in enumerate(peers):
            if health is not None and health.state(pid) != "up":
                avoided_parts.append(i + 1)
            else:
                remote.append((i + 1, cli))
        snap = node.tx.gts.current()
        lsn = node.palf.replica.applied_lsn
        t0 = time.time()       # record timestamp (wall)
        m0 = time.monotonic()  # elapsed source (step-proof)
        # cancel correlation: remote fragments register under the
        # statement's token so a KILL/timeout on the coordinator can
        # stop in-flight remote work via the idempotent dtl.cancel verb
        from oceanbase_tpu_torch.server import admission as qadmission

        _ctx = qadmission.current()
        cancel_token = _ctx.token if _ctx is not None else ""
        results: list = [None] * nparts
        ship_bytes = [0] * nparts
        slice_s = [0.0] * nparts
        errors: list = [None] * nparts
        # want_lanes is the coordinator's (stable) monitor-knob state —
        # it picks the fragment executable VARIANT on every data node,
        # so sampling (want_ops) never alternates the compile key even
        # when a node's own knob setting differs from the coordinator's
        want_lanes = monitor is not None
        want_ops = want_lanes and collect
        # full-link trace: the fan-out/merge runs under one exchange
        # span; worker threads re-activate the statement's context so
        # per-slice spans (and the rpc spans beneath them, carrying the
        # remote halves back) parent correctly across threads
        tctx = qtrace.current()
        exch = qtrace.span("dtl.exchange", table=push.table,
                           parts=nparts)
        with exch as xsp:
            tparent = qtrace.current_span_id()

            def run_peer(i, cli):
                with qtrace.activate(tctx, tparent):
                    with qtrace.span("dtl.slice", part=i,
                                     peer=cli.peer_id):
                        s0 = time.monotonic()
                        try:
                            res, sent, recv = cli.call_with_size(
                                "dtl.execute", plan=push.encoded,
                                table=push.table, snapshot=snap,
                                part=i, nparts=nparts,
                                applied_lsn=lsn, with_ops=want_ops,
                                monitor_lanes=want_lanes,
                                cancel_token=cancel_token)
                            verify_reply(res, i, cli.peer_id)
                            results[i] = res
                            ship_bytes[i] = sent + recv
                        except Exception as e:  # noqa: BLE001 — triaged
                            errors[i] = e
                        slice_s[i] = time.monotonic() - s0

            threads = [threading.Thread(target=run_peer, args=(i, cli),
                                        daemon=True)
                       for i, cli in remote]

            def _cancel_remote():
                # best-effort, idempotent: stop in-flight remote
                # fragments; a peer that already finished (or never
                # got the fragment) just plants a tombstone.  This IS
                # the unwind path — it must run to completion even for
                # a killed statement, bounded by dtl.cancel's 2s policy
                for _i, cli in remote:  # obcheck: ok(cancel.loop-no-checkpoint)
                    try:
                        cli.call("dtl.cancel", token=cancel_token)
                    except Exception:  # noqa: BLE001 — unwinding
                        pass

            try:
                for t in threads:
                    t.start()
                # the coordinator's own slice — and every slice routed
                # away from an unhealthy peer — runs locally while
                # peers work
                for i in avoided_parts:
                    with qtrace.span("dtl.slice", part=i, local=1):
                        s0 = time.monotonic()
                        results[i] = node._h_dtl_execute(
                            plan=push.encoded, table=push.table,
                            snapshot=snap, part=i, nparts=nparts,
                            with_ops=want_ops,
                            monitor_lanes=want_lanes)
                        slice_s[i] = time.monotonic() - s0
                # slice-join checkpoint loop: instead of a blind join,
                # poll so a KILL/timeout on the coordinator unwinds
                # NOW and cancels the in-flight remote fragments
                while any(t.is_alive() for t in threads):
                    for t in threads:
                        t.join(0.05)
                        if t.is_alive():
                            break
                    qadmission.checkpoint()
                for t in threads:
                    t.join()
            except (qadmission.QueryKilled, qadmission.QueryTimeout):
                if cancel_token and remote:
                    _cancel_remote()
                raise
            fallbacks = 0
            from oceanbase_tpu_torch.net.rpc import RpcError

            for i, err in enumerate(errors):
                if err is None:
                    continue
                if isinstance(err, RpcError) and \
                        err.kind == "CapacityOverflow":
                    # static budgets overflowed remotely: surface it so
                    # the session re-plans (scaled caps re-serialize)
                    raise CapacityOverflow(str(err))
                from oceanbase_tpu_torch.storage.integrity import (
                    CorruptionError,
                )

                if not isinstance(err, (RpcError, OSError,
                                        ConnectionError,
                                        CorruptionError)):
                    raise err
                # node down / lagging replica / schema not yet applied /
                # reply failed its payload digest: run that slice on
                # the local replica instead
                with qtrace.span("dtl.slice", part=i, local=1,
                                 fallback=1):
                    s0 = time.monotonic()
                    results[i] = node._h_dtl_execute(
                        plan=push.encoded, table=push.table,
                        snapshot=snap, part=i, nparts=nparts,
                        with_ops=want_ops, monitor_lanes=want_lanes)
                    slice_s[i] = time.monotonic() - s0
                fallbacks += 1
            if node.palf.replica.applied_lsn != lsn:
                # a commit landed while slices were executing: its
                # version may be <= snap yet its WAL entry postdates the
                # lag guard, so caught-up and lagging slices could
                # DISAGREE on its visibility — a tear no single-replica
                # read can produce.  Discard the fan-out; the serial
                # path re-reads one replica consistently.
                xsp.tags["discarded"] = 1
                return None
            merge_mon = [] if monitor is not None else None
            with qtrace.span("dtl.merge", parts=nparts):
                # merge_s covers ONLY the host-side concatenation: the
                # final-merge execute_plan books its own dispatch/device
                # time through the accumulator like any other execution
                mm0 = time.monotonic()
                rel = merge_fragments(results,
                                      device=getattr(node, "device", None))
                pp.add_exec_times(merge_s=time.monotonic() - mm0)
                out = execute_plan(push.rebuilt, {DTL_TABLE: rel},
                                   monitor_out=merge_mon,
                                   monitor_collect=collect)
            # fold the splits REMOTE fragments shipped back into the
            # statement's accumulator (locally-run slices already
            # accumulated on this thread); rec.remote_device_s makes
            # the cluster's device time visible per exchange
            from oceanbase_tpu_torch.exec.plan import add_exec_times

            remote_device_s = 0.0
            for i, _cli in remote:
                if errors[i] is not None or results[i] is None:
                    continue  # slice re-ran locally (already counted)
                tm = results[i].get("tm")
                if tm and len(tm) == 5:
                    add_exec_times(host_s=tm[0] * 1e-6,
                                   device_s=tm[1] * 1e-6,
                                   flops=tm[2], bytes=tm[3],
                                   calls=tm[4])
                    remote_device_s += tm[1] * 1e-6
            rows_shipped = sum(r["rows"] for i, r in enumerate(results)
                               if i > 0 and ship_bytes[i] > 0)
            elapsed = time.monotonic() - m0
            rec = DtlRecord(
                ts=t0, table=push.table, mode="pushdown", parts=nparts,
                pushdown_hit=True, bytes_shipped=sum(ship_bytes),
                rows_shipped=rows_shipped, fallback_parts=fallbacks,
                avoided_parts=len(avoided_parts) - 1,
                elapsed_s=elapsed,
                remote_device_s=round(remote_device_s, 6),
                slice_rows=[int(r["rows"]) for r in results],
                slice_bytes=list(ship_bytes),
                slice_elapsed=[round(s, 6) for s in slice_s])
            xsp.tags.update(fallbacks=fallbacks,
                            avoided=rec.avoided_parts,
                            bytes=rec.bytes_shipped,
                            slice_skew=round(rec.slice_skew, 3))
        self.metrics.record(rec)
        we = getattr(getattr(node, "db", None), "wait_events", None)
        if we is not None:
            we.add("dtl exchange", elapsed)
        if want_ops:
            # estimate-vs-actual ledger for the DTL path: per-slice op
            # rows (shipped back beside the data, ``spans``-style, as
            # bare postorder int lists) sum across slices and q-error
            # against the coordinator's estimates on its own copy of
            # the partial plan — op names come from that copy too, so
            # the reply pays rows-only wire cost.  The final-merge
            # plan's own rows and the exchange summary follow.
            # Positions renumber over the merged sequence.
            per_op: list | None = None
            for r in results:
                ops = r.get("ops")
                if ops is None:
                    continue
                if per_op is None:
                    per_op = [0] * len(ops)
                for j, cnt in enumerate(ops):
                    if j < len(per_op):
                        per_op[j] += int(cnt)
            base = len(monitor)
            if per_op:
                nodes = pp.monitored_postorder(push.remote)
                ests = [n.est_rows for n in nodes]
                names = [type(n).__name__ for n in nodes]
                for j, cnt in enumerate(per_op):
                    est = ests[j] if j < len(ests) else None
                    name = names[j] if j < len(names) else "Op"
                    monitor.append({
                        "op": "DtlPartial:" + name, "pos": 0,
                        "est": est, "rows": cnt,
                        "q_error": pp.q_error(est, cnt),
                        "elapsed_s": 0.0})
            monitor.extend(merge_mon or [])
            monitor.append({
                "op": (f"DtlExchange(parts={nparts},"
                       f"fallback={fallbacks},"
                       f"avoided={rec.avoided_parts},"
                       f"bytes={rec.bytes_shipped})"),
                "pos": 0, "est": None, "rows": rows_shipped,
                "q_error": 0.0, "elapsed_s": elapsed})
            for k in range(base, len(monitor)):
                monitor[k]["pos"] = k
        return out
