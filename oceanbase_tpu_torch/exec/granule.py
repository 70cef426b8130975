"""Granule streaming: scan pipelines over tables larger than device memory.

Port of ``oceanbase_tpu/exec/granule.py`` (≙ the granule iterator + pump,
ObGranuleIteratorOp / ObGranulePump::fetch_granule_task,
src/sql/engine/px/ob_granule_pump.cpp:361).  The host feeds a table to
the device in fixed-capacity granules; each granule runs the plan's scan
subtree (and a partial aggregate), and the partials merge on the device
through the same partial/final split the PX exchange uses
(``px/dist_ops.py::split_aggs``).

Supported pipeline shapes: a single-table TableScan/Filter/Project
subtree, optionally under GroupBy or ScalarAgg, with Sort/Limit/Project
coordinator ops on top.

The upload (``GranuleUploader``): each granule's columns go through a
ring of pinned host buffers (depth 2, as ``prefetch_iter``) and reach
the device by asynchronous copies on a dedicated copy stream; the
compute stream waits on each copy's event, and a pinned buffer is
refilled only after the copy that last read it has finished.  The
device tensors are allocated under the copy stream and marked with
``record_stream`` for the compute stream, so the allocator never hands
their memory out again while a granule program still reads it.

Differences from the reference:

- every granule program and the final merge of ``execute_streamed`` run
  inside one ``diag.collect()``, and the run raises
  ``CapacityOverflow`` at its one host read, where the reference drops
  a partial or final group-by overflow without a word (ROADMAP Queue 3
  #9);
- only the columns the scan reads are encoded and uploaded; the
  string-dictionary pre-pass unions Python sets (the same sorted values
  as ``np.unique`` over object arrays, about 50x faster) and a granule's
  codes come from a hash lookup (the same codes as ``searchsorted``);
- ``segment_chunk_provider`` (LSM granules with MVCC merge) computes the
  reference's newest-wins rule vectorized instead of row by row.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.datatypes import SqlType, torch_dtype
from oceanbase_tpu_torch.exec import diag, ops
from oceanbase_tpu_torch.exec import plan as pp
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.px.dist_ops import split_aggs
from oceanbase_tpu_torch.px.planner import NotDistributable, split_top
from oceanbase_tpu_torch.storage.segment import key_ids
from oceanbase_tpu_torch.storage.tablet import _rows_to_arrays
from oceanbase_tpu_torch.vector.column import (
    Column,
    Relation,
    StringDict,
    bucket_capacity,
    from_numpy,
    host_column,
    to_numpy,
)

DEFAULT_CHUNK_ROWS = 1 << 21  # ~2M rows per granule
RING_DEPTH = 2  # pinned upload slots, as deep as prefetch_iter's queue


def snap_chunk_rows(chunk_rows: int) -> int:
    """Snap a granule capacity onto the shared bucket ladder, as the
    reference does (there, so that chunk programs compile once per
    rung; here, so that capacities and overflow retries match)."""
    return bucket_capacity(chunk_rows)


def _find_single_scan(node):
    """The streamed subtree must read exactly one base table."""
    tabs = pp.referenced_tables(node)
    if len(tabs) != 1:
        raise NotDistributable("streaming needs a single-table subtree")
    return next(iter(tabs))


def scan_columns(node) -> list | None:
    """The source columns the subtree's TableScan nodes read, or None
    when one of them reads every column."""
    out: list = []
    stack = [node]
    while stack:
        nd = stack.pop()
        if isinstance(nd, pp.TableScan):
            if nd.columns is None:
                return None
            out.extend(c for c in nd.columns if c not in out)
        stack.extend(nd.children())
    return out


def _pick(d: dict, cols: list | None) -> dict:
    return dict(d) if cols is None else {k: v for k, v in d.items()
                                         if k in cols}


def extract_column_bounds(node) -> dict:
    """Collect per-source-column [lo, hi] bounds from the Filter chain for
    zone-map chunk pruning (≙ the white filters the blockscan applies on
    index-block aggregates before decoding micro blocks).

    Only top-level AND conjuncts of the shapes col cmp literal survive;
    everything else is simply not used for pruning (safe over-approx).
    Returns {source_col: (lo|None, hi|None)} in SOURCE column names
    (TableScan rename reversed)."""
    from oceanbase_tpu_torch.expr.compile import literal_value

    bounds: dict[str, list] = {}
    rename_inv: dict[str, str] = {}

    def visit(nd):
        if isinstance(nd, pp.TableScan) and nd.rename:
            for src, cid in nd.rename.items():
                rename_inv[cid] = src
        for c in nd.children():
            visit(c)
        if isinstance(nd, pp.Filter):
            for conj in _conjuncts(nd.pred):
                _one(conj)

    def _conjuncts(e):
        if isinstance(e, ir.Logic) and e.op == "and":
            for a in e.args:
                yield from _conjuncts(a)
        else:
            yield e

    def _one(e):
        if not isinstance(e, ir.Cmp):
            return
        col, lit_, op = None, None, e.op
        if isinstance(e.left, ir.ColumnRef) and isinstance(e.right, ir.Literal):
            col, lit_ = e.left.name, e.right
        elif isinstance(e.right, ir.ColumnRef) and \
                isinstance(e.left, ir.Literal):
            col, lit_ = e.right.name, e.left
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}.get(op)
        if col is None or op is None:
            return
        try:
            v, t = literal_value(lit_)
        except Exception:  # noqa: BLE001 — non-foldable literal
            return
        # only types whose literal representation equals the stored
        # representation prune safely (decimal literals carry their own
        # textual scale, which may differ from the column's)
        if t.kind.value not in ("int", "date", "datetime", "bool"):
            return
        if not isinstance(v, (int, np.integer)):
            return
        v = int(v)
        src = rename_inv.get(col, col)
        lo, hi = bounds.get(src, [None, None])
        if op in (">", ">="):
            lo = v if lo is None else max(lo, v)
        elif op in ("<", "<="):
            hi = v if hi is None else min(hi, v)
        elif op == "=":
            lo = v if lo is None else max(lo, v)
            hi = v if hi is None else min(hi, v)
        bounds[src] = [lo, hi]

    visit(node)
    return {k: tuple(v) for k, v in bounds.items()}


def prefetch_iter(it, depth: int = 2):
    """Overlap host-side granule production (decode, parse, disk reads)
    with device compute: a daemon thread runs the producer ahead into a
    small bounded queue (≙ the IO manager's async prefetch,
    src/share/io/ob_io_manager.h — here one prefetcher per stream).

    Exceptions in the producer re-raise at the consumer's next pull.
    Abandoning the iterator (early break / GeneratorExit — a LIMIT that
    stops mid-stream) stops the producer and CLOSES the wrapped
    generator from its own thread, so provider finalizers (open spill
    file handles) still run."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def put_until_stopped(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put_until_stopped(item):
                    break
        except BaseException as e:  # noqa: BLE001 — ship to consumer
            put_until_stopped(("__exc__", e))
            return
        finally:
            if stop.is_set() and hasattr(it, "close"):
                # generator close must run on the thread that executes
                # the generator — that's this one
                try:
                    it.close()
                except Exception:
                    pass
        put_until_stopped(_END)

    t = threading.Thread(target=run, daemon=True,
                         name="granule-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and \
                    item[0] == "__exc__":
                raise item[1]
            yield item
    finally:
        stop.set()
        t.join(timeout=5)


# ---------------------------------------------------------------------------
# the granule upload
# ---------------------------------------------------------------------------


@dataclass
class StreamStats:
    """What a streamed run moved to the device and when.  The event
    pairs are CUDA timing events (copy stream, compute stream); reading
    their times synchronizes, so do it after the run."""

    granules: int = 0
    h2d_bytes: int = 0
    copy_events: list = field(default_factory=list)
    compute_events: list = field(default_factory=list)

    def copy_ms(self) -> float:
        """Summed device time of the host-to-device copies."""
        return sum(a.elapsed_time(b) for a, b in self.copy_events)

    def compute_ms(self) -> float:
        """Summed device time of the granule programs."""
        return sum(a.elapsed_time(b) for a, b in self.compute_events)


class GranuleUploader:
    """Host granule columns -> device tensors of ``chunk_rows`` lanes.

    On a CUDA device: a ring of ``RING_DEPTH`` slots of pinned buffers,
    one per column, and asynchronous copies on a dedicated copy stream (see
    the module docstring).  On the CPU, asked for by the caller: a plain
    padded copy.  An upload error on CUDA raises; nothing falls back."""

    def __init__(self, device, chunk_rows: int):
        self.device = default_device(device)
        self.chunk_rows = chunk_rows
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device=self.device)
            self._ring: list[dict] = [{} for _ in range(RING_DEPTH)]
            self._done: list = [None] * RING_DEPTH
            self._slot = 0

    def upload(self, host: dict, n: int,
               stats: StreamStats | None = None) -> dict:
        """{name: ndarray of n rows} -> {name: tensor}; the lanes past
        ``n`` are zero (False for bool)."""
        cap = self.chunk_rows
        if not self.cuda:
            out = {}
            for k, a in host.items():
                buf = np.zeros(cap, dtype=a.dtype)
                buf[:n] = a
                out[k] = torch.from_numpy(buf)
            return out
        slot = self._slot
        self._slot = (slot + 1) % len(self._ring)
        if self._done[slot] is not None:
            # the copy that last read this slot's buffers has finished
            self._done[slot].synchronize()
        bufs = self._ring[slot]
        for k, a in host.items():
            dt = torch_dtype(a.dtype)
            buf = bufs.get(k)
            if buf is None or buf.dtype != dt:
                buf = torch.empty(cap, dtype=dt, pin_memory=True)
                bufs[k] = buf
            np.copyto(buf.numpy()[:n], a)
        compute = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        out = {}
        with torch.cuda.stream(self.copy_stream):
            start.record()
            for k, a in host.items():
                buf = bufs[k]
                dst = torch.empty(cap, dtype=buf.dtype, device=self.device)
                dst[:n].copy_(buf[:n], non_blocking=True)
                if n < cap:
                    dst[n:].zero_()
                # allocated under the copy stream, read on the compute
                # stream: keep the block until that work has run
                dst.record_stream(compute)
                out[k] = dst
            done.record()
        compute.wait_event(done)
        self._done[slot] = done
        if stats is not None:
            stats.h2d_bytes += sum(n * a.dtype.itemsize
                                   for a in host.values())
            stats.copy_events.append((start, done))
        return out

    def drain(self):
        """Wait for every copy still reading a pinned slot, so the ring
        can be released or dropped (a stream that unwinds on a KILL or a
        timeout calls this before its buffers go)."""
        if not self.cuda:
            return
        for i, ev in enumerate(self._done):
            if ev is not None:
                ev.synchronize()
                self._done[i] = None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def execute_streamed(plan: pp.PlanNode, chunk_provider,
                     chunk_rows: int = DEFAULT_CHUNK_ROWS,
                     types: dict | None = None,
                     cache: dict | None = None,
                     device=None,
                     stats: StreamStats | None = None) -> Relation:
    """Run ``plan`` by streaming the scanned table in fixed-size granules
    onto ``device`` (default ``"cuda"``).

    chunk_provider(table_name, chunk_rows[, bounds]) -> iterator of
    ({col -> numpy array}, {col -> valid or None}) host chunks; must be
    re-iterable (string columns need a dictionary pre-pass so every
    granule shares one encoding and the partials merge).

    Pass the same ``cache`` dict across calls to reuse the string
    dictionaries and the pinned upload ring (repeat executions of one
    plan).  ``stats`` collects the run's upload bytes and timing events.

    The partials stay on the device and merge there; the one host read
    is the overflow check at the end, which raises
    ``diag.CapacityOverflow`` when a granule or the merge dropped rows.
    """
    dev = default_device(device)
    chunk_rows = snap_chunk_rows(chunk_rows)
    top, scalar_agg, droot = split_top(plan)

    # peel a GroupBy into partial (per-granule) + final (merge) phases
    group_node = None
    if isinstance(droot, pp.GroupBy):
        group_node = droot
        droot = droot.child
    table = _find_single_scan(droot)
    cols = scan_columns(droot)

    partial_specs = final_specs = post = None
    keys = None
    if group_node is not None:
        partial_specs, final_specs, post = split_aggs(group_node.aggs)
        keys = group_node.keys
    elif scalar_agg is not None:
        partial_specs, final_specs, post = split_aggs(scalar_agg.aggs)

    ckey = (plan.fingerprint(), chunk_rows, str(dev))
    if cache is not None and cache.get("key") == ckey:
        gdicts = cache["gdicts"]
        uploader = cache["uploader"]
    else:
        # dictionary pre-pass: one global order-preserving dict per string
        # column so all granules share an encoding (mergeable partials)
        gdicts = _global_dicts(chunk_provider, table, chunk_rows, cols)
        uploader = GranuleUploader(dev, chunk_rows)
        if cache is not None:
            cache.update(key=ckey, gdicts=gdicts, uploader=uploader)

    def chunk_fn(rel):
        rel = pp._lower(droot, {table: rel})
        if group_node is not None:
            cap = min(group_node.out_capacity or 1 << 16, rel.capacity)
            return ops.hash_groupby(rel, keys, partial_specs,
                                    out_capacity=cap)
        if partial_specs is not None:
            return ops.scalar_agg(rel, partial_specs)
        return ops.compact(rel)

    timed = stats is not None and dev.type == "cuda"

    def run_granule(rel):
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = chunk_fn(rel)
        if timed:
            end.record()
            stats.compute_events.append((start, end))
        if stats is not None:
            stats.granules += 1
        return out

    # zone-map pushdown: range bounds from the filter chain let providers
    # skip whole chunks before decode/upload (≙ blockscan index-skip)
    bounds = extract_column_bounds(droot)

    partials = []
    with diag.collect() as entries:
        for arrays, valids in prefetch_iter(
                chunk_provider(table, chunk_rows, bounds)):
            n = len(next(iter(arrays.values())))
            if n == 0:
                continue
            rel = _chunk_to_relation(_pick(arrays, cols), _pick(valids, cols),
                                     types, gdicts, chunk_rows, n, uploader,
                                     stats)
            partials.append(run_granule(rel))

        if not partials:
            # zone maps pruned everything: one all-dead granule, so
            # aggregates produce their correct empty-input results
            try:
                arrays, valids = next(iter(
                    chunk_provider(table, chunk_rows, None)))
            except StopIteration:
                raise ValueError("no granules produced") from None
            n = len(next(iter(arrays.values())))
            rel = _chunk_to_relation(_pick(arrays, cols), _pick(valids, cols),
                                     types, gdicts, chunk_rows, n, uploader)
            rel = Relation(columns=rel.columns,
                           mask=torch.zeros(rel.capacity, dtype=torch.bool,
                                            device=dev))
            partials.append(chunk_fn(rel))
        merged = ops.concat(partials) if len(partials) > 1 else partials[0]

        if group_node is not None:
            rel = ops.hash_groupby(merged, {k: ir.col(k) for k in keys},
                                   final_specs,
                                   out_capacity=group_node.out_capacity)
            outs = {k: ir.col(k) for k in keys}
            outs.update(post)
            rel = ops.project(rel, outs)
        elif scalar_agg is not None:
            rel = ops.scalar_agg(merged, final_specs)
            rel = ops.project(rel, dict(post))
        else:
            rel = merged

        for node in reversed(top):
            if isinstance(node, pp.Sort):
                rel = ops.sort_rows(rel, node.keys, node.ascending)
            elif isinstance(node, pp.Limit):
                rel = ops.limit(rel, node.k, node.offset)
            elif isinstance(node, pp.Project):
                rel = ops.project(rel, node.outputs)
    pp.check_overflow(entries)
    return rel


def execute_sorted_streamed(
    plan: pp.PlanNode, chunk_provider, spill_dir: str,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    budget_rows: int = 1 << 22, types: dict | None = None, device=None,
):
    """ORDER BY over a table larger than host memory: granules filter on
    the device, live rows drain to the host, and the external merge sort
    (exec/external_sort.py) spills runs to ``spill_dir``.  A Limit above
    the Sort stops the merge as soon as offset+k rows have emerged —
    the tail of the merged stream is never read off disk.

    Supported shape: [Project?] [Limit?] Sort over a single-table
    scan/filter/project subtree with plain column sort keys.
    -> (arrays, valids) of the final (sorted, limited) host columns."""
    from oceanbase_tpu_torch.exec.external_sort import external_sort
    from oceanbase_tpu_torch.storage.tmpfile import TempFileStore

    dev = default_device(device)
    chunk_rows = snap_chunk_rows(chunk_rows)
    top, scalar_agg, droot = split_top(plan)
    if scalar_agg is not None or isinstance(droot, pp.GroupBy):
        raise NotDistributable("sorted streaming is for scan pipelines")
    sort_node = None
    limit_node = None
    projects = []
    for node in top:  # outermost-first
        if isinstance(node, pp.Sort) and sort_node is None:
            sort_node = node
        elif isinstance(node, pp.Limit) and sort_node is None:
            limit_node = node
        elif isinstance(node, pp.Project) and sort_node is None:
            projects.append(node)
        else:
            raise NotDistributable("unsupported op above streamed sort")
    if sort_node is None:
        raise NotDistributable("no Sort to stream")
    key_cols = []
    for k in sort_node.keys:
        if not isinstance(k, ir.ColumnRef):
            raise NotDistributable("streamed sort needs column keys")
        key_cols.append(k.name)

    table = _find_single_scan(droot)
    cols = scan_columns(droot)
    gdicts = _global_dicts(chunk_provider, table, chunk_rows, cols)
    bounds = extract_column_bounds(droot)
    uploader = GranuleUploader(dev, chunk_rows)
    # a scan pipeline compacted: execute_plan checks its overflow lanes
    chunk_plan = pp.Compact(droot)

    def host_chunks():
        for arrays, valids in chunk_provider(table, chunk_rows, bounds):
            n = len(next(iter(arrays.values())))
            if n == 0:
                continue
            rel = _chunk_to_relation(_pick(arrays, cols), _pick(valids, cols),
                                     types, gdicts, chunk_rows, n, uploader)
            host = to_numpy(pp.execute_plan(chunk_plan, {table: rel}))
            out_cols = [c for c in host if not c.startswith("__valid__")]
            a = {c: host[c] for c in out_cols}
            v = {c: host.get("__valid__" + c) for c in out_cols}
            if len(next(iter(a.values()))) == 0:
                continue
            yield a, v

    want = None
    if limit_node is not None:
        want = limit_node.k + limit_node.offset

    parts_a: list = []
    parts_v: list = []
    got = 0
    with TempFileStore(spill_dir) as store:
        for arrays, valids in external_sort(
                host_chunks(), key_cols, sort_node.ascending, store,
                budget_rows=budget_rows):
            parts_a.append(arrays)
            parts_v.append(valids)
            got += len(next(iter(arrays.values())))
            if want is not None and got >= want:
                break  # early exit: the merge tail stays on disk
    if not parts_a:
        return {}, {}
    out_cols = list(parts_a[0])
    arrays = {}
    valids = {}
    for c in out_cols:
        chunks = [p[c] for p in parts_a]
        if any(x.dtype == object for x in chunks):
            chunks = [x.astype(object) for x in chunks]
        arrays[c] = np.concatenate(chunks)
        if any(v.get(c) is not None for v in parts_v):
            valids[c] = np.concatenate(
                [vv[c] if vv.get(c) is not None
                 else np.ones(len(a[c]), dtype=bool)
                 for vv, a in zip(parts_v, parts_a)])
    if limit_node is not None:
        lo = limit_node.offset
        hi = lo + limit_node.k
        arrays = {c: a[lo:hi] for c, a in arrays.items()}
        valids = {c: v[lo:hi] for c, v in valids.items()}
    # apply the Project chain above the Sort (innermost-first; Projects
    # are row-wise so they commute with the Limit slice).  Plain column
    # selections/renames run on the host; computed outputs round-trip the
    # (already limited) result through the device expression engine.
    for node in reversed(projects):
        if all(isinstance(e, ir.ColumnRef) for e in node.outputs.values()):
            arrays = {nm: arrays[e.name] for nm, e in node.outputs.items()}
            valids = {nm: valids.get(e.name)
                      for nm, e in node.outputs.items()}
        else:
            rel = from_numpy(arrays,
                             valids={c: v for c, v in valids.items()
                                     if v is not None}, device=dev)
            host = to_numpy(ops.project(rel, node.outputs))
            out_cols = [c for c in host if not c.startswith("__valid__")]
            arrays = {c: host[c] for c in out_cols}
            valids = {c: host.get("__valid__" + c) for c in out_cols}
    return arrays, valids


# ---------------------------------------------------------------------------
# granules
# ---------------------------------------------------------------------------


def _is_string(v: np.ndarray) -> bool:
    return v.dtype == object or v.dtype.kind in "US"


def _global_dicts(chunk_provider, table, chunk_rows, columns=None):
    """Pre-pass: union of unique values per string column -> sorted dict
    (only the ``columns`` the scan reads, when given)."""
    uniq: dict[str, set] = {}
    found_strings = False
    for arrays, _valids in chunk_provider(table, chunk_rows):
        for k, v in _pick(arrays, columns).items():
            if _is_string(v):
                found_strings = True
                uniq.setdefault(k, set()).update(v.tolist())
        if not found_strings:
            break  # no string columns anywhere: skip the full pre-pass
    return {k: StringDict(np.array(sorted(u), dtype=object))
            for k, u in uniq.items()}


def _encode(sd: StringDict, strings: np.ndarray) -> np.ndarray:
    """The reference's ``searchsorted`` codes of ``strings`` in the
    global dictionary ``sd``, by a hash lookup at about half its host
    time; a value the pre-pass never saw (the dead probe granule's "")
    takes the ``searchsorted`` path."""
    index = sd.__dict__.get("_index")
    if index is None:
        index = {v: i for i, v in enumerate(sd.values.tolist())}
        object.__setattr__(sd, "_index", index)
    try:
        return np.fromiter(map(index.__getitem__, strings.tolist()),
                           dtype=np.int32, count=len(strings))
    except KeyError:
        return np.searchsorted(
            sd.values, np.asarray(strings, dtype=object)).astype(np.int32)


def _chunk_to_relation(arrays, valids, types, gdicts, chunk_rows, n,
                       uploader: GranuleUploader,
                       stats: StreamStats | None = None):
    """Build a fixed-capacity device relation for one granule: every
    column padded to ``chunk_rows`` lanes, the lanes past ``n`` dead."""
    host: dict[str, np.ndarray] = {}
    meta: dict[str, tuple] = {}
    for k, v in arrays.items():
        sd = gdicts.get(k)
        if sd is not None:
            host[k] = _encode(sd, v)
            meta[k] = (SqlType.string(), sd)
        else:
            host[k], t = host_column(np.asarray(v), (types or {}).get(k))
            meta[k] = (t, None)
        vv = (valids or {}).get(k)
        if vv is not None:
            host["__valid__" + k] = np.asarray(vv, dtype=np.bool_)
    dev = uploader.upload(host, n, stats)
    cols = {k: Column(dev[k], dev.get("__valid__" + k), t, sd)
            for k, (t, sd) in meta.items()}
    mask = None
    if n < chunk_rows:
        mask = torch.arange(chunk_rows, device=uploader.device) < n
    return Relation(columns=cols, mask=mask)


def numpy_chunk_provider(arrays: dict, valids: dict | None = None):
    """Granules from in-memory numpy columns (bench path)."""

    def provider(table, chunk_rows, bounds=None):
        n = len(next(iter(arrays.values())))
        for s in range(0, n, chunk_rows):
            e = min(s + chunk_rows, n)
            yield ({k: v[s:e] for k, v in arrays.items()},
                   {k: (v[s:e] if v is not None else None)
                    for k, v in (valids or {}).items()})

    return provider


def segment_chunk_provider(tablet, snapshot: int):
    """Granules straight from the LSM with the reference's MVCC merge
    semantics (≙ the multi-way merge iterator fusing memtable +
    SSTables, ob_multiple_scan_merge).

    LSM order: memtables first (newest), then segments newest->oldest,
    rows within a part newest-version-first; a key's first appearance in
    that order is authoritative, and a tombstone there suppresses the
    older versions too.  The reference walks every row in Python with a
    seen-key set; here the rule is vectorized: the key columns of every
    visible part are read first, ``segment.key_ids`` numbers the key
    tuples, and ``np.unique(..., return_index=True)`` over the parts in
    LSM order finds each key's first appearance.  The parts' other
    columns are decoded afterwards, one part at a time; a column a
    segment predates (ALTER TABLE ADD COLUMN) reads as NULL.  Zone-map
    ``bounds`` prune only columns whose stored values share the integer
    literal's domain: the reference also prunes DECIMAL columns by the
    unscaled literal and drops the chunks that match (ROADMAP Queue 3
    #11)."""

    # extract_column_bounds keeps integer-typed literals only; they
    # prune in the stored value domain of integer, date and bool columns,
    # never of a DECIMAL column's scaled ints (ROADMAP Queue 3 #11)
    same_domain = {c for c, t in tablet.types.items()
                   if t.kind.value in ("int", "date", "datetime", "bool")}

    def provider(table, chunk_rows, bounds=None):
        key_cols = tablet.key_cols
        with tablet._lock:
            mem_parts = []
            for mt in tablet.memtables():
                rows = mt.snapshot_rows(snapshot)
                if rows:
                    mem_parts.append(_rows_to_arrays(rows, tablet.columns,
                                                     tablet.types))
            segs = list(tablet.segments[::-1])
        # each part: (key arrays, deleted, later-decode thunk)
        parts = []
        for a, v in mem_parts:
            parts.append(([a[k] for k in key_cols], a["__deleted__"],
                          (lambda a=a, v=v: (a, v))))
        for seg in segs:
            if seg.min_version > snapshot:
                continue
            chunk_mask = None
            if bounds:
                chunk_mask = np.ones(seg.n_chunks, dtype=bool)
                for col, (lo, hi) in bounds.items():
                    if col in seg.columns and col in same_domain:
                        chunk_mask &= seg.prune_chunks(col, lo, hi)
                if not chunk_mask.any():
                    continue  # whole segment skipped by zone maps
                if chunk_mask.all():
                    chunk_mask = None
            meta = [c for c in ("__deleted__", "__version__")
                    if c in seg.columns]
            ka, _kv = seg.decode(names=list(key_cols) + meta,
                                 chunk_mask=chunk_mask)
            vis = None
            if seg.max_version > snapshot and "__version__" in ka:
                vis = ka["__version__"] <= snapshot
                ka = {k: x[vis] for k, x in ka.items()}

            def decode(seg=seg, chunk_mask=chunk_mask, vis=vis):
                arrays, valids = seg.decode(
                    names=[c for c in tablet.columns if c in seg.columns],
                    chunk_mask=chunk_mask)
                if vis is not None:
                    arrays = {k: x[vis] for k, x in arrays.items()}
                    valids = {k: (x[vis] if x is not None else None)
                              for k, x in valids.items()}
                # a column added after this segment was written (ALTER
                # TABLE ADD COLUMN rewrites nothing) reads as NULL
                n = len(next(iter(arrays.values()))) if arrays else 0
                for c in tablet.columns:
                    if c not in arrays:
                        t = tablet.types[c]
                        arrays[c] = (np.full(n, "", dtype=object)
                                     if t.is_string
                                     else np.zeros(n, dtype=t.np_dtype))
                        valids[c] = np.zeros(n, dtype=bool)
                return arrays, valids

            parts.append(([ka[k] for k in key_cols], ka.get("__deleted__"),
                          decode))
        keeps = _newest_first_keep(parts)
        for (_keys, _deleted, decode), keep in zip(parts, keeps):
            if not keep.any():
                continue
            arrays, valids = decode()
            out_a = {k: a[keep] for k, a in arrays.items()
                     if k in tablet.columns}
            out_v = {k: (x[keep] if x is not None else None)
                     for k, x in valids.items() if k in tablet.columns}
            n = int(keep.sum())
            for s in range(0, n, chunk_rows):
                e = min(s + chunk_rows, n)
                yield ({k: a[s:e] for k, a in out_a.items()},
                       {k: (x[s:e] if x is not None else None)
                        for k, x in out_v.items()})

    return provider


def _newest_first_keep(parts) -> list:
    """Per part, the rows ``segment_chunk_provider`` yields: the first
    appearance of each key in LSM order (parts in order, each part's
    rows last to first), unless that appearance is a tombstone."""
    sizes = [len(keys[0]) if keys else 0 for keys, _d, _f in parts]
    total = sum(sizes)
    if total == 0:
        return [np.zeros(n, dtype=bool) for n in sizes]
    ncols = len(parts[0][0])
    seq = [np.concatenate([np.asarray(keys[c])[::-1]
                           for keys, _d, _f in parts])
           for c in range(ncols)]
    _u, first = np.unique(key_ids(seq), return_index=True)
    win = np.zeros(total, dtype=bool)
    win[first] = True
    out, off = [], 0
    for (_keys, deleted, _f), n in zip(parts, sizes):
        keep = win[off:off + n][::-1].copy()
        if deleted is not None:
            keep &= ~np.asarray(deleted, dtype=bool)
        out.append(keep)
        off += n
    return out


__all__ = [
    "DEFAULT_CHUNK_ROWS", "GranuleUploader", "StreamStats",
    "execute_sorted_streamed", "execute_streamed", "extract_column_bounds",
    "numpy_chunk_provider", "prefetch_iter", "scan_columns",
    "segment_chunk_provider", "snap_chunk_rows",
]
