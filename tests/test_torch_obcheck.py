"""obcheck over the port (``oceanbase_tpu_torch/analysis``) against the
reference's (``oceanbase_tpu/analysis``).

Seven families are copies: the reference's fixtures (``test_obcheck.py``,
``test_metrics.py``'s registry half), moved to the port's paths, go
through both packages' checkers and must give the same (rule, line,
func, message) lists.  ``trace_safety`` is rewritten for eager torch:
its fixtures are in torch idiom, one per reference fixture plus one per
torch sync pattern.  Then the root registry against the reference's jit
roots, the tier-1 gate on the port's tree (run once for the module),
and the CLI end to end.
"""

import json
import os
import subprocess
import sys

import pytest

from oceanbase_tpu.analysis import core as rcore
from oceanbase_tpu.analysis import mask_discipline as rmd
from oceanbase_tpu.analysis.cancel_rules import check_cancel_rules as r_cancel
from oceanbase_tpu.analysis.io_rules import check_io_rules as r_io
from oceanbase_tpu.analysis.lock_order import check_lock_order as r_lock
from oceanbase_tpu.analysis.mask_discipline import (
    check_mask_discipline as r_mask,
)
from oceanbase_tpu.analysis.metric_rules import check_metric_rules as r_metric
from oceanbase_tpu.analysis.rpc_rules import check_rpc_rules as r_rpc
from oceanbase_tpu.analysis.time_rules import check_time_rules as r_time
from oceanbase_tpu.analysis.trace_safety import (
    _Index as RIndex,
    _traced_roots,
)
from oceanbase_tpu_torch.analysis import core as pcore
from oceanbase_tpu_torch.analysis import mask_discipline as pmd
from oceanbase_tpu_torch.analysis import trace_safety as pts
from oceanbase_tpu_torch.analysis.cancel_rules import (
    check_cancel_rules as p_cancel,
)
from oceanbase_tpu_torch.analysis.io_rules import check_io_rules as p_io
from oceanbase_tpu_torch.analysis.lock_order import check_lock_order as p_lock
from oceanbase_tpu_torch.analysis.mask_discipline import (
    check_mask_discipline as p_mask,
)
from oceanbase_tpu_torch.analysis.metric_rules import (
    check_metric_rules as p_metric,
)
from oceanbase_tpu_torch.analysis.rpc_rules import check_rpc_rules as p_rpc
from oceanbase_tpu_torch.analysis.time_rules import check_time_rules as p_time
from oceanbase_tpu_torch.analysis.trace_safety import check_trace_safety

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_obcheck.py")
REF, PORT = "oceanbase_tpu/", "oceanbase_tpu_torch/"


def _port(text: str) -> str:
    """A reference fixture (source or path) moved to the port's package."""
    return text.replace("oceanbase_tpu", "oceanbase_tpu_torch")


def _rules(findings):
    return sorted({f.rule for f in findings})


def _sig(findings):
    return [(f.rule, f.line, f.func, f.message) for f in findings]


# ---------------------------------------------------------------------------
# the reference's fixtures (tests/test_obcheck.py, tests/test_metrics.py)
# ---------------------------------------------------------------------------

MASK_BAD = '''
import jax.numpy as jnp

def leaky_total(rel):
    total = jnp.zeros(())
    for c in rel.columns.values():
        total = total + jnp.sum(c.data)
    return total
'''

MASK_CLEAN = '''
import jax.numpy as jnp

def masked_total(rel):
    m = rel.mask_or_true()
    total = jnp.zeros(())
    for c in rel.columns.values():
        total = total + jnp.sum(jnp.where(m, c.data, 0))
    return total
'''

LOCK_INVERSION = '''
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.peer = B()

    def one(self):
        with self._lock:
            self.peer.two()

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.owner = A()

    def two(self):
        with self._lock:
            return 1

    def back(self):
        with self._lock:
            self.owner.one()
'''

LOCK_CLEAN = '''
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.peer = B()

    def one(self):
        with self._lock:
            pass
        self.peer.two()   # lock released before calling out

class B:
    def __init__(self):
        self._lock = threading.Lock()

    def two(self):
        with self._lock:
            return 1
'''

UNLOCKED_MUT = '''
import threading

class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = {}

    def put(self, k, v):
        self.items[k] = v

    def get(self, k):
        with self._lock:
            return self.items.get(k)
'''

IO_BAD = '''
import os

def save_blob(path, payload):
    with open(path + ".tmp", "wb") as f:
        f.write(payload)
    os.replace(path + ".tmp", path)
'''

IO_CLEAN = '''
import os

from oceanbase_tpu.native import crc64

def save_blob(path, payload):
    digest = crc64(payload)
    with open(path + ".tmp", "wb") as f:
        f.write(payload + digest.to_bytes(8, "little"))
    os.replace(path + ".tmp", path)
'''

IO_CLEAN_TRANSITIVE = '''
import os

from oceanbase_tpu.native import crc64

def _stamp(payload):
    return payload + crc64(payload).to_bytes(8, "little")

def save_blob(path, payload):
    with open(path + ".tmp", "wb") as f:
        f.write(_stamp(payload))
    os.replace(path + ".tmp", path)
'''

INPLACE_BAD = '''
from oceanbase_tpu.native import crc64

def save_meta(path, payload):
    with open(path, "w") as f:
        f.write(payload + str(crc64(payload.encode())))
'''

INPLACE_STAGED = '''
import os

from oceanbase_tpu.native import crc64

def save_meta(path, payload):
    with open(path + ".tmp", "w") as f:
        f.write(payload + str(crc64(payload.encode())))
    os.replace(path + ".tmp", path)
'''

INPLACE_APPEND = '''
from oceanbase_tpu.native import crc64

def append_meta(path, payload):
    with open(path, "a") as f:
        f.write(payload + str(crc64(payload.encode())))
'''

CANCEL_BAD = '''
def drain(cli, items):
    out = []
    for it in items:
        out.append(cli.call("das.scan", item=it))
    return out
'''

CANCEL_CLEAN = '''
from oceanbase_tpu.server import admission as qadmission

def drain(cli, items):
    out = []
    for it in items:
        qadmission.checkpoint()
        out.append(cli.call("das.scan", item=it))
    return out
'''

CANCEL_NAMESAKE = '''
def drain(cli, items, tenant):
    out = []
    for it in items:
        tenant.checkpoint()  # the STORAGE checkpoint, not admission
        out.append(cli.call("das.scan", item=it))
    return out
'''

CANCEL_FANOUT = '''
import threading

def scatter(clients, frag):
    def run_one(cli):
        return cli.call("dtl.execute", frag=frag)
    ts = [threading.Thread(target=run_one) for cli in clients]
    for t in ts:
        t.start()
'''

CANCEL_FANOUT_FIXED = CANCEL_FANOUT.replace(
    "    for t in ts:\n        t.start()",
    "    for t in ts:\n        t.start()\n"
    "    for cli in clients:  # obcheck: ok(cancel.loop-no-checkpoint)\n"
    '        cli.call("dtl.cancel")')

RPC_POLICY_SRC = '''
POLICIES: dict = {
    "das.scan":    VerbPolicy(30.0, True, 3),
    "sql.execute": VerbPolicy(600.0, False),
}
'''

RPC_HANDLERS_SRC = '''
class S:
    def handlers(self):
        return {
            "das.scan": self._h_scan,
            "node.rogue": self._h_rogue,
        }
'''

RPC_RESEND_SRC = '''
def forward(cli, sql):
    for _ in range(3):
        try:
            return cli.call("sql.execute", sql=sql)
        except OSError:
            pass
'''

RPC_BULK = '''
def h_scan(table):
    return {"arrays": {}, "total": 0}
'''

METRIC_BAD = '''
import jax
from oceanbase_tpu.server import metrics as qmetrics

qmetrics.declare("good.counter", "counter", "d")
GOOD = qmetrics.declare("good.const", "counter", "d")

def traced(x):
    qmetrics.inc("good.counter")
    return x + 1

jax.jit(traced)

def host(name):
    qmetrics.inc("good.counter")
    qmetrics.inc(GOOD)
    qmetrics.inc("never.declared")
    qmetrics.observe(f"dyn.{name}", 1.0)
'''

METRIC_CLEAN = '''
from oceanbase_tpu.server import metrics as qmetrics

qmetrics.declare("good.counter", "counter", "d")

def host():
    qmetrics.inc("good.counter", verb="x")
'''

TIME_BAD = '''
import time

def elapsed():
    t0 = time.time()
    work()
    return time.time() - t0
'''

TIME_CLEAN = '''
import time

def elapsed(record):
    t0 = time.monotonic()
    work()
    age = time.time() - record.ts
    return time.monotonic() - t0, age
'''


def _exempting(checker, **kw):
    """A checker with its registry overridden (paths moved by caller)."""
    def run(az):
        return checker(az, **kw)
    return run


# family -> (reference checker, port checker); a case is (family, files
# keyed by the reference's paths, the rules the port must report, the
# registry overrides as keyword arguments keyed by reference paths)
CHECKERS = {"lock": (r_lock, p_lock), "io": (r_io, p_io),
            "cancel": (r_cancel, p_cancel), "metric": (r_metric, p_metric),
            "rpc": (r_rpc, p_rpc), "mask": (r_mask, p_mask),
            "time": (r_time, p_time)}

PRAGMA_MUT = UNLOCKED_MUT.replace(
    "        self.items[k] = v",
    "        # obcheck: ok(lock.unlocked-mut)\n        self.items[k] = v")
IO_PRAGMA = IO_BAD.replace(
    '    with open(path + ".tmp", "wb") as f:',
    '    with open(path + ".tmp", "wb") as f:'
    '  # obcheck: ok(io.unverified-write)')
INPLACE_PRAGMA = INPLACE_BAD.replace(
    '    with open(path, "w") as f:',
    '    with open(path, "w") as f:  # obcheck: ok(io.inplace-durable-write)')
MASK_PRAGMA = MASK_BAD.replace(
    "def leaky_total(rel):",
    "def leaky_total(rel):  # obcheck: ok(mask.drop)")
CANCEL_PRAGMA = CANCEL_BAD.replace(
    "    for it in items:", "    for it in items:  # obcheck: ok(cancel)")
RPC_RESEND_PRAGMA = RPC_RESEND_SRC.replace(
    'return cli.call("sql.execute", sql=sql)',
    'return cli.call(  # obcheck: ok(rpc.nonidempotent-resend)\n'
    '                "sql.execute", sql=sql)')
METRIC_PRAGMA = METRIC_BAD.replace(
    'qmetrics.inc("never.declared")',
    'qmetrics.inc("never.declared")  # obcheck: ok(metric)')

PARITY = {
    "lock-inversion": ("lock", {"tx/fixture.py": LOCK_INVERSION},
                       ["lock.inversion"], {}),
    "lock-clean": ("lock", {"tx/fixture.py": LOCK_CLEAN}, [], {}),
    "lock-unlocked-mut": ("lock", {"tx/fixture.py": UNLOCKED_MUT},
                          ["lock.unlocked-mut"], {}),
    "lock-pragma": ("lock", {"tx/fixture.py": PRAGMA_MUT}, [], {}),
    "lock-out-of-scope": ("lock", {"share/fixture.py": LOCK_INVERSION},
                          [], {}),
    "io-unverified": ("io", {"storage/blob.py": IO_BAD},
                      ["io.unverified-write"], {}),
    "io-out-of-scope": ("io", {"exec/blob.py": IO_BAD}, [], {}),
    "io-clean": ("io", {"storage/blob.py": IO_CLEAN}, [], {}),
    "io-clean-transitive": ("io", {"storage/blob.py": IO_CLEAN_TRANSITIVE},
                            [], {}),
    "io-pragma": ("io", {"storage/blob.py": IO_PRAGMA}, [], {}),
    "io-exempt": ("io", {"storage/blob.py": IO_BAD}, [],
                  {"exempt": {"storage/blob.py": {"save_blob": "t"}}}),
    "io-hygiene": ("io", {"storage/blob.py": IO_CLEAN},
                   ["io.unregistered-exemption"],
                   {"exempt": {"storage/blob.py": {"save_blob": "stale",
                                                   "ghost_fn": "gone"}}}),
    "io-inplace": ("io", {"storage/meta.py": INPLACE_BAD},
                   ["io.inplace-durable-write"], {}),
    "io-inplace-staged": ("io", {"storage/meta.py": INPLACE_STAGED}, [], {}),
    "io-inplace-append": ("io", {"storage/meta.py": INPLACE_APPEND}, [], {}),
    "io-inplace-pragma": ("io", {"storage/meta.py": INPLACE_PRAGMA}, [], {}),
    "io-inplace-exempt": (
        "io", {"storage/meta.py": INPLACE_BAD}, [],
        {"inplace_exempt": {"storage/meta.py": {"save_meta": "verified"}}}),
    "io-inplace-hygiene": (
        "io", {"storage/meta.py": INPLACE_STAGED},
        ["io.unregistered-exemption"],
        {"inplace_exempt": {"storage/meta.py": {"save_meta": "stale",
                                                "ghost_fn": "gone"}}}),
    "cancel-loop": ("cancel", {"exec/pump.py": CANCEL_BAD},
                    ["cancel.loop-no-checkpoint"], {}),
    "cancel-out-of-scope": ("cancel", {"share/pump.py": CANCEL_BAD}, [], {}),
    "cancel-pure-cpu": (
        "cancel", {"exec/pump.py":
                   "def f(items):\n    return [i * 2 for i in items]\n"},
        [], {}),
    "cancel-clean": ("cancel", {"exec/pump.py": CANCEL_CLEAN}, [], {}),
    "cancel-namesake": ("cancel", {"exec/pump.py": CANCEL_NAMESAKE},
                        ["cancel.loop-no-checkpoint"], {}),
    "cancel-pragma": ("cancel", {"exec/pump.py": CANCEL_PRAGMA}, [], {}),
    "cancel-exempt": ("cancel", {"exec/pump.py": CANCEL_BAD}, [],
                      {"exempt": {"exec/pump.py": {"drain": "unwind"}}}),
    "cancel-hygiene": (
        "cancel", {"exec/pump.py": CANCEL_CLEAN},
        ["cancel.stale-exempt", "cancel.unknown-exempt"],
        {"exempt": {"exec/pump.py": {"drain": "stale", "ghost_fn": "x"}}}),
    "cancel-fanout": ("cancel", {"px/scatter.py": CANCEL_FANOUT},
                      ["cancel.fanout-no-propagation"], {}),
    "cancel-fanout-fixed": ("cancel", {"px/scatter.py": CANCEL_FANOUT_FIXED},
                            [], {}),
    "metric-registry": ("metric", {"pkg/mod.py": METRIC_BAD},
                        ["metric.dynamic-name", "metric.undeclared"], {}),
    "metric-clean": ("metric", {"pkg/mod.py": METRIC_CLEAN}, [], {}),
    # the pragma covers its line and the next (the dynamic name's)
    "metric-pragma": ("metric", {"pkg/mod.py": METRIC_PRAGMA}, [], {}),
    "rpc-missing-policy": ("rpc", {"net/rpc.py": RPC_POLICY_SRC,
                                   "net/extra.py": RPC_HANDLERS_SRC},
                           ["rpc.missing-policy"], {}),
    "rpc-resend": ("rpc", {"net/rpc.py": RPC_POLICY_SRC,
                           "net/fwd.py": RPC_RESEND_SRC},
                   ["rpc.nonidempotent-resend"], {}),
    "rpc-resend-idempotent": (
        "rpc", {"net/rpc.py": RPC_POLICY_SRC,
                "net/fwd.py": RPC_RESEND_SRC.replace("sql.execute",
                                                     "das.scan")}, [], {}),
    "rpc-resend-pragma": ("rpc", {"net/rpc.py": RPC_POLICY_SRC,
                                  "net/fwd.py": RPC_RESEND_PRAGMA}, [], {}),
    "rpc-resend-no-policy-file": ("rpc", {"px/fwd.py": RPC_RESEND_SRC},
                                  ["rpc.nonidempotent-resend"], {}),
    "rpc-bulk": ("rpc", {"net/extra.py": RPC_BULK},
                 ["rpc.bulk-no-digest"], {}),
    "rpc-bulk-digest": (
        "rpc", {"net/extra.py": RPC_BULK.replace('"total": 0',
                                                 '"total": 0, "crc": 0')},
        [], {}),
    "mask-drop": ("mask", {"px/leaky.py": MASK_BAD}, ["mask.drop"], {}),
    "mask-out-of-scope": ("mask", {"share/leaky.py": MASK_BAD}, [], {}),
    "mask-clean": ("mask", {"px/ok.py": MASK_CLEAN}, [], {}),
    "mask-pragma": ("mask", {"px/leaky.py": MASK_PRAGMA}, [], {}),
    "time-wall-elapsed": ("time", {"server/t.py": TIME_BAD},
                          ["time.wall-elapsed"], {}),
    "time-clean": ("time", {"server/t.py": TIME_CLEAN}, [], {}),
}


def _moved(reg: dict, prefix: str) -> dict:
    return {prefix + p: v for p, v in reg.items()}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_family_parity_with_the_reference(case):
    """The same fixture through both packages' checker: the same
    (rule, line, func, message) list, and the rules expected."""
    family, files, want, overrides = PARITY[case]
    rchk, pchk = CHECKERS[family]
    rkw = {k: _moved(v, REF) for k, v in overrides.items()}
    pkw = {k: _moved(v, PORT) for k, v in overrides.items()}
    rfound = rcore.run_all({REF + p: s for p, s in files.items()},
                           [_exempting(rchk, **rkw)])
    pfound = pcore.run_all({PORT + p: _port(s) for p, s in files.items()},
                           [_exempting(pchk, **pkw)])
    if family == "metric":
        # the registry half: metric.jit-reachable reads each package's
        # own device scope (jax.jit roots there, EXECUTION_ROOTS here)
        rfound = [f for f in rfound if f.rule != "metric.jit-reachable"]
    assert _sig(pfound) == _sig(rfound)
    assert _rules(pfound) == want
    assert all(f.path.startswith(PORT) for f in pfound)


def test_mask_registry_hygiene_parity():
    """Stale and unknown CONTRACTS entries are findings in both."""
    out = []
    for md, prefix, chk, src in ((rmd, REF, r_mask, MASK_CLEAN),
                                 (pmd, PORT, p_mask, _port(MASK_CLEAN))):
        path = prefix + "px/ok.py"
        md.CONTRACTS[path] = {"masked_total": "bogus", "ghost_fn": "gone"}
        try:
            out.append(_sig(rcore.run_all({path: src}, [chk])
                            if md is rmd else
                            pcore.run_all({path: src}, [chk])))
        finally:
            del md.CONTRACTS[path]
    assert out[1] == out[0]
    assert sorted({r for r, *_ in out[1]}) == ["mask.stale-exempt",
                                               "mask.unknown-exempt"]


def test_metric_device_scope_reads_the_registry():
    """metric.jit-reachable keeps its id and reads trace_safety's
    EXECUTION_ROOTS: an update inside a registered root is flagged, the
    same update in host code is not."""
    src = _port(METRIC_CLEAN) + (
        "\ndef body(x):\n    qmetrics.inc(\"good.counter\")\n    return x\n")
    path = PORT + "exec/plan.py"
    old = dict(pts.EXECUTION_ROOTS)
    pts.EXECUTION_ROOTS.clear()
    pts.EXECUTION_ROOTS[path] = {"body": ("fixture",)}
    try:
        found = pcore.run_all({path: src}, [p_metric])
    finally:
        pts.EXECUTION_ROOTS.clear()
        pts.EXECUTION_ROOTS.update(old)
    assert [(f.rule, f.func) for f in found] == [
        ("metric.jit-reachable", "body")]


# ---------------------------------------------------------------------------
# trace_safety in torch idiom
# ---------------------------------------------------------------------------

T_PATH = PORT + "exec/bad.py"

TRACED_BAD = '''
import torch

def body(x):
    s = torch.sum(x)
    n = int(s)
    if s > 0:
        return s
    return s * n
'''

HOST_BAD = '''
import torch

def run_plan(x):
    return torch.sum(x), torch.amax(x)

def caller(x):
    out, ovf = run_plan(x)
    if int(ovf) > 0:
        raise RuntimeError("overflow")
    return out
'''

TRACED_CLEAN = '''
import torch

def body(x, rel):
    s = torch.sum(x)
    k = int(x.shape[0])  # static metadata: fine
    if k > 4:            # python int: fine
        return s * 2
    if rel.mask is None or x.is_floating_point():
        return s
    return torch.where(rel.mask, x, torch.zeros_like(x)).sum()
'''

CACHE_BAD = '''
import functools

class Holder:
    def __init__(self, plan):
        self.plan = plan

@functools.lru_cache(maxsize=8)
def compile_plan(holder):
    return holder

def lookup(plan):
    return compile_plan(Holder(plan))
'''

CACHE_CLEAN = '''
import functools

class Holder:
    def __init__(self, plan, key):
        self.plan = plan
        self.key = key

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Holder) and other.key == self.key

@functools.lru_cache(maxsize=8)
def compile_plan(holder):
    return holder

def lookup(plan):
    return compile_plan(Holder(plan, repr(plan)))
'''


def _trace(src, roots=("body",), entries=(), path=T_PATH):
    def chk(az):
        return check_trace_safety(
            az, roots={path: {r: ("fixture",) for r in roots}},
            entries={path: tuple(entries)}, boundaries={})
    return pcore.run_all({path: src}, [chk])


def test_trace_catches_a_sync_in_the_device_scope():
    found = _trace(TRACED_BAD)
    assert _rules(found) == ["trace.host-sync", "trace.tracer-branch"]
    sync = [f for f in found if f.rule == "trace.host-sync"]
    assert [f.line for f in sync] == [6] and "int(s)" in sync[0].message
    # outside the registry the same body is host code on host values
    assert _trace(TRACED_BAD, roots=()) == []


def test_trace_catches_a_sync_on_an_entry_points_result():
    found = _trace(HOST_BAD, roots=(), entries=("run_plan",))
    syncs = [f for f in found if f.rule == "trace.host-sync"]
    assert len(syncs) == 1 and "int(ovf)" in syncs[0].message
    assert syncs[0].func == "caller"
    # not an entry point: its results are not the card's
    assert _trace(HOST_BAD, roots=()) == []


def test_trace_clean_fixture_passes():
    assert _trace(TRACED_CLEAN) == []


def test_trace_cache_key_identity_hash():
    assert _rules(_trace(CACHE_BAD, roots=())) == ["trace.cache-key"]
    assert _trace(CACHE_CLEAN, roots=()) == []


def test_trace_pragma_suppresses():
    src = TRACED_BAD.replace(
        "    n = int(s)",
        "    n = int(s)  # obcheck: ok(trace.host-sync)").replace(
        "    if s > 0:",
        "    # obcheck: ok(trace)\n    if s > 0:")
    assert _trace(src) == []


def test_trace_unknown_root():
    found = _trace(TRACED_CLEAN, roots=("body", "renamed_body"))
    assert _rules(found) == ["trace.unknown-root"]
    assert found[0].func == "renamed_body"
    # a module the tree lacks is not unknown: it applies when it lands
    def chk(az):
        return check_trace_safety(
            az, roots={PORT + "net/node.py": {"gone": ("x",)}},
            entries={}, boundaries={})
    assert pcore.run_all({T_PATH: TRACED_CLEAN}, [chk]) == []


SEEDED = {
    "item": "v = torch.sum(x).item()",
    "tolist": "v = x.tolist()",
    "cpu": "v = x.cpu()",
    "numpy": "v = x.numpy()",
    "to-cpu": "v = x.to(\"cpu\")",
    "to-device-cpu": "v = x.to(device=\"cpu\")",
    "float": "v = float(torch.amax(x))",
    "bool": "v = bool(torch.any(x))",
    "np-asarray": "v = np.asarray(torch.sum(x))",
    "np-array-payload": "v = np.array(rel.mask)",
    "cuda-synchronize": "torch.cuda.synchronize()",
    "event-synchronize": "ev = torch.cuda.Event()\n    ev.synchronize()",
    "nonzero": "v = torch.nonzero(x)",
    "nonzero-tuple": "v = x.nonzero(as_tuple=True)",
    "unique": "v = torch.unique(x)",
    "masked-select": "v = torch.masked_select(x, rel.mask)",
    "bincount": "v = torch.bincount(x)",
    "where-one-arg": "v = torch.where(rel.mask)",
    "repeat-interleave": "v = torch.repeat_interleave(x, x)",
    "from-numpy-upload": "v = torch.from_numpy(a).to(x.device)",
    "tensor-upload": "v = torch.tensor([1, 2], device=x.device)",
    "as-tensor-upload": "v = torch.as_tensor(a, device=x.device)",
    "equal": "v = torch.equal(x, x)",
}

CLEAN_TWINS = {
    "repeat-interleave-sized":
        "v = torch.repeat_interleave(x, x, output_size=8)",
    "repeat-interleave-scalar": "v = torch.repeat_interleave(x, 2)",
    "pinned-upload": "v = torch.from_numpy(a).to(x.device, "
                     "non_blocking=True)",
    "host-tensor": "v = torch.tensor([1, 2])",
    "cpu-tensor": "v = torch.as_tensor(a, device=\"cpu\")",
    "np-unique": "v = np.unique(a)",
    "metadata": "v = int(x.numel()) + x.dim() + int(x.shape[0])",
}


def _seeded(line):
    return ("import numpy as np\nimport torch\n\n"
            "def body(x, rel, a):\n    " + line + "\n    return v\n")


@pytest.mark.parametrize("pattern", sorted(SEEDED))
def test_trace_flags_each_torch_sync(pattern):
    found = _trace(_seeded(SEEDED[pattern]))
    assert _rules(found) == ["trace.host-sync"], [f.render() for f in found]
    # a host function outside any execution: only the torch.* ops that
    # size their output from the data are flagged everywhere
    host = _trace(_seeded(SEEDED[pattern]), roots=())
    always = pattern in ("nonzero", "unique", "masked-select", "bincount",
                         "where-one-arg", "repeat-interleave")
    assert bool(host) == always


@pytest.mark.parametrize("pattern", sorted(CLEAN_TWINS))
def test_trace_passes_each_clean_twin(pattern):
    assert _trace(_seeded(CLEAN_TWINS[pattern])) == []


def test_trace_tensor_branch():
    src = ("import torch\n\ndef body(x, m):\n"
           "    if torch.any(m):\n        return x\n"
           "    live = torch.sum(m)\n"
           "    while live > 0:\n        live = live - 1\n    return x\n")
    found = _trace(src)
    assert [(f.rule, f.line) for f in found] == [
        ("trace.tracer-branch", 4), ("trace.tracer-branch", 7)]


def test_trace_host_half_of_an_entry_point():
    """An entry point's own body and the helpers it calls (short of a
    boundary) are the execution's host half: a torch result read there
    is flagged, the boundary's copy is not."""
    src = '''
import torch

def to_host(t):
    return t.cpu()

def _check(lanes):
    return int(torch.stack(lanes).sum())

def run(x):
    s = torch.sum(x)
    _check([s])
    return to_host(s)
'''
    path = T_PATH

    def chk(boundaries):
        def run_chk(az):
            return check_trace_safety(
                az, roots={}, entries={path: ("run",)},
                boundaries=boundaries)
        return run_chk

    found = pcore.run_all({path: src}, [chk({})])
    assert [(f.func, f.line) for f in found] == [("to_host", 5),
                                                 ("_check", 8)]
    found = pcore.run_all({path: src},
                          [chk({path: {"to_host": "the result boundary"}})])
    assert [(f.func, f.line) for f in found] == [("_check", 8)]


def test_parse_error_is_a_finding():
    found = pcore.run_all({PORT + "exec/broken.py": "def f(:\n"},
                          [check_trace_safety])
    assert [f.rule for f in found] == ["trace.parse-error"]


def test_pragma_family_prefix_and_exact():
    az = pcore.Analyzer({"x.py": "a = 1  # obcheck: ok(trace)\n"
                                 "b = 2  # obcheck: ok(mask.drop, "
                                 "lock.inversion)\n"
                                 "c = 3\n"})
    assert az.suppressed("x.py", 1, "trace.host-sync")
    assert az.suppressed("x.py", 2, "mask.drop")
    assert az.suppressed("x.py", 2, "lock.inversion")
    assert not az.suppressed("x.py", 2, "mask.stale-exempt")
    assert az.suppressed("x.py", 2, "trace.host-sync")
    assert az.suppressed("x.py", 3, "mask.drop")
    assert not az.suppressed("x.py", 3, "trace.host-sync")


def test_run_all_marked_keeps_suppressed_findings():
    src = TRACED_BAD.replace(
        "    n = int(s)", "    n = int(s)  # obcheck: ok(trace.host-sync)")

    def chk(az):
        return check_trace_safety(az, roots={T_PATH: {"body": ("f",)}},
                                  entries={}, boundaries={})

    marked = pcore.run_all_marked({T_PATH: src}, [chk])
    assert [(f.rule, f.line, sup) for f, sup in marked] == [
        ("trace.host-sync", 6, True), ("trace.tracer-branch", 7, False)]
    assert [f for f, sup in marked if not sup] == \
        pcore.run_all({T_PATH: src}, [chk])


def test_baseline_only_reports_new(tmp_path):
    fs = {PORT + "tx/fixture.py": UNLOCKED_MUT}
    first = pcore.run_all(fs, [p_lock])
    assert first
    bp = str(tmp_path / "base.json")
    pcore.write_baseline(first, bp)
    base = pcore.load_baseline(bp)
    assert pcore.diff_findings(first, base) == []
    src = UNLOCKED_MUT + (
        "\n    def drop(self, k):\n        self.items.pop(k, None)\n")
    second = pcore.run_all({PORT + "tx/fixture.py": src}, [p_lock])
    new = pcore.diff_findings(second, base)
    assert len(new) == 1 and "pop" in new[0].message


# ---------------------------------------------------------------------------
# the registry against the reference's roots, and the repo gate
# ---------------------------------------------------------------------------


def test_every_reference_root_maps_to_a_port_root():
    """The reference's jit roots (computed over its tree) each stand
    behind an EXECUTION_ROOTS entry, and each entry names a reference
    root that exists."""
    ridx = RIndex(rcore.Analyzer(rcore.load_package_files(REPO)))
    ref_roots = {f"{p[len(REF):]}::{q}" for p, q in _traced_roots(ridx)}
    assert len(ref_roots) >= 11
    mapped = {r for quals in pts.EXECUTION_ROOTS.values()
              for refs in quals.values() for r in refs}
    assert ref_roots <= mapped, sorted(ref_roots - mapped)
    assert mapped <= ref_roots, sorted(mapped - ref_roots)


@pytest.fixture(scope="module")
def port_tree():
    """The port's whole tree through every checker, once for the module
    (pre-pragma, each finding marked), with its seconds."""
    import time

    t0 = time.perf_counter()
    files = pcore.load_package_files(REPO)
    marked = pcore.run_all_marked(files)
    return files, marked, time.perf_counter() - t0


def test_repo_is_clean_vs_baseline(port_tree):
    """Tier-1 gate: a new host sync, mask drop, lock inversion, ... in
    the port fails here with the finding's file:line and message."""
    _files, marked, seconds = port_tree
    findings = [f for f, sup in marked if not sup]
    new = pcore.diff_findings(findings, pcore.load_baseline())
    assert not new, "NEW obcheck findings:\n" + "\n".join(
        f.render() for f in new)
    assert seconds < 60.0


def test_baseline_ships_empty():
    assert pcore.load_baseline() == {}


def _line_of(files, path, needle):
    lines = files[PORT + path].splitlines()
    hits = [i + 1 for i, ln in enumerate(lines) if needle in ln]
    assert len(hits) == 1, (path, needle, hits)
    return hits[0]


@pytest.mark.parametrize("path,needle", [
    ("expr/compile.py", "return torch.from_numpy(np.ascontiguousarray("
                        "values)).to("),
    ("exec/plan.py", "pos = torch.nonzero(live)"),
    ("exec/plan.py", "vals = vec.tolist()"),
    ("px/dist_ops.py", "n_over = int(overflow)"),
    ("px/exchange.py", "cap = max(int(counts.max()), 1)"),
    ("px/planner.py", "n_over = int(total_ovf)"),
])
def test_known_syncs_fire(port_tree, path, needle):
    """The port's known host syncs each carry a finding before pragmas
    (ROADMAP items (l), (l2) and the overflow reads)."""
    files, marked, _s = port_tree
    line = _line_of(files, path, needle)
    hits = [f for f, _sup in marked if f.rule == "trace.host-sync"
            and f.path == PORT + path and f.line == line]
    assert hits, f"no trace.host-sync at {path}:{line}"


def test_no_unknown_registry_entry(port_tree):
    _files, marked, _s = port_tree
    assert not [f for f, _sup in marked if "unknown" in f.rule]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(root, baseline, *extra):
    return subprocess.run(
        [sys.executable, SCRIPT, "--root", str(root), "--baseline",
         str(baseline), *extra], capture_output=True, text=True)


PLAN_SYNC = '''
import torch

def _lower_inner(node, tables):
    s = torch.sum(tables["t"])
    return s, int(s)

def execute_plan(plan, tables):
    return _lower_inner(plan, tables)
'''


def test_cli_ci_gate_end_to_end(tmp_path):
    """--ci: green on a clean tree, red once one violation per family
    lands (each rule named on stderr), green after --write-baseline."""
    root = tmp_path / "mini"
    pkg = root / "oceanbase_tpu_torch"
    (pkg / "px").mkdir(parents=True)
    (pkg / "px" / "ok.py").write_text(_port(MASK_CLEAN))
    bp = tmp_path / "base.json"
    r = _cli(root, bp, "--write-baseline")
    assert r.returncode == 0, r.stderr
    r = _cli(root, bp, "--ci", "--json")
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(r.stdout.splitlines()[0])
    assert summary["metric"] == "obcheck" and summary["new"] == 0

    seeded = {
        "px/leaky.py": (MASK_BAD, "mask.drop"),
        "exec/plan.py": (PLAN_SYNC, "trace.host-sync"),
        "tx/inv.py": (LOCK_INVERSION, "lock.inversion"),
        "server/stats.py": (METRIC_BAD.replace("jax.jit(traced)", ""),
                            "metric.undeclared"),
        "server/clock.py": (TIME_BAD, "time.wall-elapsed"),
        "storage/blob.py": (IO_BAD, "io.unverified-write"),
        "exec/pump.py": (CANCEL_BAD, "cancel.loop-no-checkpoint"),
        "net/extra.py": (RPC_BULK, "rpc.bulk-no-digest"),
    }
    for rel, (src, _rule) in seeded.items():
        f = pkg / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(_port(src))
    r = _cli(root, bp, "--ci", "--json")
    assert r.returncode == 1
    summary = json.loads(r.stdout.splitlines()[0])
    assert summary["new"] >= len(seeded)
    for _src, rule in seeded.values():
        assert rule in r.stderr, rule
    r = _cli(root, bp, "--write-baseline")
    assert r.returncode == 0
    r = _cli(root, bp, "--ci")
    assert r.returncode == 0


def test_cli_family_filter(tmp_path):
    """--family narrows both the checkers run and the rules reported;
    the --json summary carries per-family timings; --write-baseline
    refuses a partial run."""
    root = tmp_path / "mini"
    pkg = root / "oceanbase_tpu_torch"
    (pkg / "storage").mkdir(parents=True)
    (pkg / "storage" / "blob.py").write_text(IO_BAD)
    (pkg / "exec").mkdir()
    (pkg / "exec" / "pump.py").write_text(CANCEL_BAD)
    none = tmp_path / "none.json"
    r = _cli(root, none, "--json", "--family", "io")
    summary = json.loads(r.stdout.splitlines()[0])
    assert set(summary["by_rule"]) == {"io.unverified-write"}
    assert set(summary["family_s"]) == {"io"}
    r = _cli(root, none, "--json", "--family", "cancel.loop-no-checkpoint")
    summary = json.loads(r.stdout.splitlines()[0])
    assert set(summary["by_rule"]) == {"cancel.loop-no-checkpoint"}
    r = _cli(root, none, "--json", "--family", "io", "--family", "cancel")
    summary = json.loads(r.stdout.splitlines()[0])
    assert set(summary["by_rule"]) == {"io.unverified-write",
                                       "cancel.loop-no-checkpoint"}
    r = _cli(root, none, "--write-baseline", "--family", "io")
    assert r.returncode == 2


def test_cli_loads_neither_torch_nor_jax(tmp_path):
    """The CLI is stdlib AST work: no torch, jax or reference import."""
    root = tmp_path / "mini"
    (root / "oceanbase_tpu_torch" / "px").mkdir(parents=True)
    (root / "oceanbase_tpu_torch" / "px" / "ok.py").write_text(
        _port(MASK_CLEAN))
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{SCRIPT!r}, '--json', '--root', {str(root)!r}]\n"
        "try:\n"
        f"    runpy.run_path({SCRIPT!r}, run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "               ('torch', 'jax', 'jaxlib', 'oceanbase_tpu'))\n"
        "print('HEAVY', heavy)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.splitlines()[0])["new"] == 0
    assert r.stdout.splitlines()[-1] == "HEAVY []"
