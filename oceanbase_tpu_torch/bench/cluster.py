"""A cluster of the port's node processes, driven over the rpc frame.

``NodeCluster`` boots ``python -m oceanbase_tpu_torch.net.node`` once per
node with ``subprocess.Popen`` (never a fork: a parent holding a CUDA
context must not hand it to a child), each node's stdout and stderr in
``<root>/node<i>.log`` (a pipe nobody reads would block a chatty node),
and ``OMP_NUM_THREADS=1`` for nodes on the CPU, so three nodes beside a
loaded test run do not fight over cores.  It serves the CPU tests
(``tests/test_torch_cluster.py``, ``--device cpu``) and ``chip_smoke.py``'s
phase "cluster" on the card.

Every wait polls one condition under a deadline of its own and ends with
a ``ClusterTimeout`` that names what was awaited and how far it got:
a node answering ``ping``, a leader, a follower's committed LSN, a weak
``count(*)``, a detector's state for a peer.  ``close()`` kills and
reaps every process it started.  The rot helpers (``flip_segment``,
``flip_wal_entry``) corrupt a node's files for ``bench/chaos.py``'s
scenarios.

The measurement planes' cluster halves (``bench/{trace,metrics,workload,
planqual,scrub}.py``) boot through ``boot``, as the reference's benches
boot theirs (``scripts/chaos_bench.py::boot_cluster``: fault verbs
armed, a pinned nemesis seed, ``dtl_min_rows = 1`` on every node), load
the slice through ``load_slice`` (1,000-row INSERTs on node 1, then the
followers' counts; node 1 takes the lead first if an election moved
it, ``take_lead``), and send every statement to node 1, whose lead
``lead_from`` checks before each half; ``run_half`` boots, loads and
runs a half for a twin.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.net.rpc import RpcClient, RpcError

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ClusterTimeout(TimeoutError):
    """A wait of the cluster harness ran past its deadline."""


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def wait_for(cond, deadline_s: float, what: str, poll_s: float = 0.05):
    """Poll ``cond()`` until it returns a truthy value (returned) or
    ``deadline_s`` passes; an exception inside ``cond`` counts as not
    yet.  The timeout names ``what`` and the last exception seen."""
    end = time.monotonic() + deadline_s
    last = None
    while True:
        try:
            got = cond()
            if got:
                return got
        except Exception as e:  # noqa: BLE001 — polled again
            last = e
        if time.monotonic() >= end:
            raise ClusterTimeout(
                f"waited {deadline_s:.1f}s for {what}"
                + (f" (last error: {last!r})" if last else ""))
        time.sleep(poll_s)


def rows(res: dict) -> list[tuple]:
    """The rows of a ``sql.execute`` reply, NULLs as None."""
    names = res["names"]
    n = res["rowcount"] if not names else len(
        next(iter(res["arrays"].values())))
    out = []
    for r in range(n):
        row = []
        for nm in names:
            v = res.get("valids", {}).get(nm)
            if v is not None and not v[r]:
                row.append(None)
            else:
                x = res["arrays"][nm][r]
                row.append(x.item() if hasattr(x, "item") else x)
        out.append(tuple(row))
    return out


def flip_segment(path: str) -> int:
    """Flip one seeded bit of a segment file that its checksums catch (a
    zip container has don't-care padding a flip could hit) -> the
    seed."""
    from oceanbase_tpu_torch.net.faults import bitflip_file
    from oceanbase_tpu_torch.storage.integrity import CorruptionError
    from oceanbase_tpu_torch.storage.segment import Segment

    for seed in range(1, 64):
        probe = path + ".probe"
        shutil.copyfile(path, probe)
        bitflip_file(probe, seed=seed)
        try:
            Segment.load(probe)
        except CorruptionError:
            bitflip_file(path, seed=seed)
            return seed
        finally:
            os.remove(probe)
    raise AssertionError(f"no seeded flip of {path} was detectable")


def flip_wal_entry(path: str) -> int:
    """Flip one payload bit of a COMPLETE entry three quarters into a
    WAL file (rot, not a torn append: the boot scan must fail its crc64
    and truncate there, keeping a replay prefix) -> that entry's LSN."""
    from oceanbase_tpu_torch.palf.log import _HDR, _MAGIC

    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_MAGIC):
        raise AssertionError(f"{path} is not a WAL file")
    found = []
    off = len(_MAGIC)
    while off + _HDR.size <= len(buf):
        _term, lsn, plen, _crc = _HDR.unpack_from(buf, off)
        if off + _HDR.size + plen > len(buf) or plen == 0:
            break
        found.append((off + _HDR.size, lsn))
        off += _HDR.size + plen
    if not found:
        raise AssertionError(f"{path} holds no complete entry")
    target, lsn = found[len(found) * 3 // 4]
    with open(path, "r+b") as f:
        f.seek(target)
        b = f.read(1)
        f.seek(target)
        f.write(bytes([b[0] ^ 0x10]))
    return lsn


#: the node module of the port (``NodeCluster``'s default)
PORT_NODE = "oceanbase_tpu_torch.net.node"
#: the rows gv$px_exchange shows of a node's exchange ring
#: (``server/virtual_tables.py::px_exchange``)
PX_EXCHANGE_VIEW = 1000
#: every node's knobs before its first boot (``chaos_bench.py:107-125``):
#: the admin fault verbs armed, the nemesis seed pinned, and every plan
#: considered for DTL pushdown on whichever node leads
BENCH_CONFIG = {"enable_fault_injection": True, "fault_seed": 7,
                "dtl_min_rows": 1}
#: the slice's INSERT size on a cluster (``trace_bench.py:153``)
SLICE_BATCH = 1000
#: each wait of the load: a leader, a statement, a follower's count
LOAD_WAIT_S = 300.0


class ClusterClient:
    """Statements and waits against running nodes, by their ports (a
    process that did not start them, such as a loader, uses this)."""

    def __init__(self, ports: list[int]):
        self.ports = list(ports)
        self.n = len(self.ports)
        self.clients = {i: RpcClient("127.0.0.1", self.ports[i - 1],
                                     timeout_s=30.0)
                        for i in range(1, self.n + 1)}

    def _alive(self, i: int):
        """Raise when node ``i`` is known to be dead (a harness that
        started it knows)."""

    def _running(self, i: int) -> bool:
        return True

    def close(self):
        for c in self.clients.values():
            c.close()

    def states(self, nodes=None) -> dict[int, dict]:
        """``node.state`` of every reachable node (a dead one is left
        out)."""
        out = {}
        for i in (nodes or self.clients):
            if not self._running(i):
                continue
            try:
                out[i] = self.clients[i].call("node.state", _deadline_s=2.0)
            except (OSError, RpcError):
                continue
        return out

    def leader(self, deadline_s: float = 60.0, exclude=()) -> int:
        """Wait for a node (not in ``exclude``) to report itself leader;
        -> its id, the claim of the highest term (a deposed leader may
        still claim an older one)."""
        def find():
            claims = [(int(st.get("term", 0)), i)
                      for i, st in self.states().items()
                      if st.get("role") == "leader" and i not in exclude]
            return max(claims)[1] if claims else None

        return wait_for(find, deadline_s, "a PALF leader"
                        + (f" other than {list(exclude)}" if exclude
                           else ""))

    def execute(self, i: int, sql: str, deadline_s: float = 120.0, **kw):
        """``sql.execute`` on node ``i``, retried while the cluster has
        no leader to route to (``NotLeader``/``NoQuorum``, election
        churn); any other error is raised at once.  A write is retried
        only when its request never reached a node."""
        end = time.monotonic() + deadline_s
        while True:
            try:
                return self.clients[i].call("sql.execute", sql=sql, **kw)
            except RpcError as e:
                if e.kind not in ("NotLeader", "NoQuorum") or \
                        time.monotonic() >= end:
                    raise
            except OSError as e:
                if getattr(e, "request_sent", True) or \
                        time.monotonic() >= end:
                    raise
            time.sleep(0.1)

    def health(self, i: int) -> dict[int, str]:
        """Node ``i``'s failure detector: peer -> up | suspect | down."""
        return {int(r["peer"]): r["state"] for r in self.clients[i].call(
            "cluster.health", _deadline_s=5.0)["peers"]}

    def wait_detector(self, i: int, peer: int, states,
                      deadline_s: float = 30.0) -> str:
        """Wait until node ``i``'s detector holds ``peer`` in one of
        ``states``; -> that state."""
        def seen():
            st = self.health(i).get(peer)
            return st if st in states else None

        return wait_for(seen, deadline_s,
                        f"node {i}'s detector to see node {peer} "
                        f"{'/'.join(states)}", poll_s=0.1)

    def last_exchange(self, i: int) -> dict | None:
        """The newest pushdown row of node ``i``'s gv$px_exchange."""
        got = rows(self.execute(i, (
            "select pushdown_hit, parts, fallback_parts, avoided_parts, "
            "bytes_shipped, rows_shipped, remote_device_s from "
            "gv$px_exchange where mode = 'pushdown' order by ts desc "
            "limit 1")))
        keys = ("hit", "parts", "fallback", "avoided", "bytes", "rows",
                "remote_device_s")
        return dict(zip(keys, got[0])) if got else None

    def pushdown_bytes(self) -> int:
        """The coordinators' view of the DTL wire since boot: every
        node's gv$px_exchange pushdown ``bytes_shipped``, summed
        (``metrics_bench.py:184-187`` reads node 1's, the only
        coordinator on its fresh cluster; only a coordinator records a
        pushdown).  Raises when a node's view is full: the events that
        scrolled out of it would be missing here while ``rpc.bytes``
        still counts them."""
        total = 0
        for i in sorted(self.clients):
            res = self.execute(i, "select mode, bytes_shipped from "
                                  "gv$px_exchange", consistency="weak")
            if res.get("node") != i:
                raise RuntimeError(f"weak read left node {i}")
            got = rows(res)
            if len(got) >= PX_EXCHANGE_VIEW:
                raise AssertionError(
                    f"node {i}'s gv$px_exchange holds {len(got)} rows, its "
                    f"whole view: older exchanges are no longer counted")
            total += sum(int(b) for m, b in got if m == "pushdown")
        return total

    def storm(self, i: int, statements: list[str], rounds: int,
              deadline_s: float = 120.0):
        """Start one client thread per statement against node ``i``, each
        with its own connection and server-side session (``1000 + k``,
        as the reference's storm), sending its statement ``rounds`` times
        -> ``join()``, which waits up to ``deadline_s`` and returns
        ``(results, alive)``: one ``(k, kind, reply, seconds)`` per
        statement sent (kind ``"ok"`` or the error's kind) and the
        threads still running."""
        port = self.ports[i - 1]
        out: list = []
        lock = threading.Lock()

        def client(k: int, sql: str):
            cli = RpcClient("127.0.0.1", port, timeout_s=30.0)
            try:
                for _ in range(rounds):
                    t0 = time.monotonic()
                    kind, res = "ok", None
                    try:
                        res = cli.call("sql.execute", sql=sql,
                                       session_id=1000 + k)
                    except Exception as e:  # noqa: BLE001 — the outcome
                        kind = getattr(e, "kind", type(e).__name__)
                    with lock:
                        out.append((k, kind, res, time.monotonic() - t0))
            finally:
                cli.close()

        threads = [threading.Thread(target=client, args=(k, sql),
                                    daemon=True)
                   for k, sql in enumerate(statements)]
        for t in threads:
            t.start()

        def join():
            end = time.monotonic() + deadline_s
            for t in threads:
                t.join(max(end - time.monotonic(), 0.0))
            with lock:
                return list(out), sum(t.is_alive() for t in threads)

        return join

    def count(self, i: int, table: str, where: str = "") -> int:
        res = self.execute(i, f"select count(*) from {table} {where}",
                           consistency="weak")
        if res.get("node") != i:
            raise RuntimeError(f"weak read left node {i}")
        return int(rows(res)[0][0])

    def wait_count(self, table: str, n: int, nodes, deadline_s=120.0,
                   where: str = "") -> float:
        """Wait until a weak ``count(*)`` on each of ``nodes`` reads
        ``n``; -> seconds waited."""
        t0 = time.monotonic()
        for i in nodes:
            left = max(deadline_s - (time.monotonic() - t0), 1.0)
            got = []

            def done(i=i):
                self._alive(i)
                got[:] = [self.count(i, table, where)]
                return got[0] == n

            try:
                wait_for(done, left, f"node {i}'s weak count of {table} "
                         f"to reach {n}", poll_s=0.1)
            except ClusterTimeout as e:
                raise ClusterTimeout(f"{e}; last count {got}") from None
        return time.monotonic() - t0

    def wait_caught_up(self, nodes=None, deadline_s: float = 120.0) -> int:
        """Wait until each of ``nodes`` has applied the leader's
        committed LSN (``node.state``/``recovery.state``); -> that LSN."""
        ldr = self.leader(deadline_s)
        target = int(self.clients[ldr].call(
            "node.state")["committed_lsn"])
        for i in (nodes or [j for j in self.clients if j != ldr]):
            wait_for(lambda i=i: int(self.clients[i].call(
                "recovery.state", _deadline_s=2.0)["applied_lsn"])
                >= target, deadline_s,
                f"node {i} to apply lsn {target}")
        return target


class NodeCluster(ClusterClient):
    """Node processes this harness starts (``wait=False`` returns as soon
    as they are spawned; ``wait_ready`` waits for them later; ``config``
    seeds every node's ``config.json`` before its first boot)."""

    def __init__(self, root: str, n: int = 3, device: str = "cuda",
                 lease_ms: int = 1500, boot_deadline_s: float = 120.0,
                 module: str = "oceanbase_tpu_torch.net.node",
                 wait: bool = True, config: dict | None = None):
        super().__init__(free_ports(n))
        self.root = str(root)
        self.device = device
        self.lease_ms = lease_ms
        self.module = module
        self.procs: dict[int, subprocess.Popen] = {}
        self._watch: threading.Thread | None = None
        self._watch_error: BaseException | None = None
        self._logs: dict[int, object] = {}
        #: seconds from spawn to the node's first ``ping`` answer
        self.boot_s: dict[int, float] = {}
        self._spawned: dict[int, float] = {}
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
            # a reference node (the CPU tests' comparison) stays off
            # any accelerator plugin
            env["JAX_PLATFORMS"] = "cpu"
        self.env = env
        os.makedirs(self.root, exist_ok=True)
        try:
            for i in range(1, n + 1):
                if config:
                    # every node's knobs before its first boot
                    os.makedirs(self.node_root(i), exist_ok=True)
                    with open(os.path.join(self.node_root(i),
                                           "config.json"), "w") as f:
                        json.dump(config, f)
                self.start_node(i, bootstrap=(i == 1))
            if wait:
                self.wait_ready(boot_deadline_s)
            else:
                # the boot is timed as it happens, while the caller works
                self._watch = threading.Thread(
                    target=self._watch_boot, args=(boot_deadline_s,),
                    daemon=True)
                self._watch.start()
        except BaseException:
            self.close()
            raise

    # -- processes -----------------------------------------------------
    def node_root(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}")

    def log_path(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}.log")

    def start_node(self, i: int, bootstrap: bool = False):
        peers = ",".join(f"{j}=127.0.0.1:{self.ports[j - 1]}"
                         for j in range(1, self.n + 1) if j != i)
        cmd = [sys.executable, "-m", self.module,
               "--node-id", str(i), "--port", str(self.ports[i - 1]),
               "--peers", peers, "--root", self.node_root(i),
               "--lease-ms", str(self.lease_ms)]
        if self.module.startswith("oceanbase_tpu_torch."):
            cmd += ["--device", self.device]
        if bootstrap:
            cmd.append("--bootstrap")
        old = self._logs.pop(i, None)
        if old is not None:
            old.close()
        log = self._logs[i] = open(self.log_path(i), "ab")
        self._spawned[i] = time.monotonic()
        self.procs[i] = subprocess.Popen(
            cmd, env=self.env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)

    def log_tail(self, i: int, nbytes: int = 3000) -> str:
        try:
            with open(self.log_path(i), "rb") as f:
                return f.read()[-nbytes:].decode("utf-8", "replace")
        except OSError:
            return ""

    def _running(self, i: int) -> bool:
        return self.procs.get(i) is not None and self.procs[i].poll() is None

    def _alive(self, i: int):
        if self.procs[i].poll() is not None:
            raise RuntimeError(
                f"node {i} exited with {self.procs[i].returncode}:\n"
                + self.log_tail(i))

    def wait_up(self, i: int, deadline_s: float = 120.0) -> float:
        """Wait for node ``i`` to answer ``ping``; -> seconds since its
        spawn."""
        end = time.monotonic() + deadline_s
        while True:
            self._alive(i)
            if self.clients[i].ping(_deadline_s=1.0):
                break
            if time.monotonic() >= end:
                raise ClusterTimeout(
                    f"waited {deadline_s:.1f}s for node {i} to answer "
                    f"ping:\n{self.log_tail(i)}")
            time.sleep(0.05)
        self.boot_s[i] = time.monotonic() - self._spawned[i]
        return self.boot_s[i]

    def _watch_boot(self, deadline_s: float):
        try:
            self._wait_ready(deadline_s)
        except BaseException as e:  # noqa: BLE001 — raised by wait_ready
            self._watch_error = e

    def wait_ready(self, deadline_s: float = 120.0):
        """Wait until every node answers ``ping`` and one leads; sets
        ``boot_s`` (per node, from its spawn) and ``first_leader_s``
        (from the first spawn)."""
        if self._watch is not None:
            self._watch.join(deadline_s)
            if self._watch.is_alive():
                raise ClusterTimeout(f"waited {deadline_s:.1f}s for the "
                                     f"cluster's boot")
            if self._watch_error is not None:
                raise self._watch_error
            return
        self._wait_ready(deadline_s)

    def _wait_ready(self, deadline_s: float):
        end = time.monotonic() + deadline_s
        for i in self.clients:
            self.wait_up(i, max(end - time.monotonic(), 1.0))
        self.first_leader_s = None
        t0 = min(self._spawned.values())
        self.leader(max(end - time.monotonic(), 1.0))
        self.first_leader_s = time.monotonic() - t0

    def kill(self, i: int, sig=signal.SIGKILL):
        p = self.procs[i]
        if p.poll() is None:
            p.send_signal(sig)
        p.wait(timeout=30)

    def restart(self, i: int, deadline_s: float = 120.0) -> float:
        """Start a killed node again over its root; -> seconds to its
        first ``ping`` answer."""
        self.clients[i].close()
        self.start_node(i)
        return self.wait_up(i, deadline_s)

    def wal_path(self, i: int) -> str:
        return os.path.join(self.node_root(i), "wal", f"replica_{i}.log")

    def manifest_path(self, i: int) -> str:
        return os.path.join(self.node_root(i), "data", "manifest.json")

    def segments(self, i: int, table: str) -> list[str]:
        return sorted(glob.glob(os.path.join(
            self.node_root(i), "data", "segments", f"{table}_*.npz")))

    def wipe(self, i: int):
        """Delete a (killed) node's root: its next start rebuilds."""
        shutil.rmtree(self.node_root(i), ignore_errors=True)

    def pid(self, i: int) -> int:
        return self.procs[i].pid

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        super().close()
        for f in self._logs.values():
            f.close()
        self._logs.clear()


def boot(root: str, device: str = "cuda", module: str = PORT_NODE,
         wait: bool = True) -> "NodeCluster":
    """A 3-node cluster as ``scripts/chaos_bench.py::boot_cluster`` boots
    it (:101-151): ``BENCH_CONFIG`` in every node's ``config.json``
    before its first boot, node 1 the bootstrap node; ``module`` picks
    the package."""
    return NodeCluster(root, n=3, device=device, module=module, wait=wait,
                       config=BENCH_CONFIG)


def lead_from(c: ClusterClient, node: int = 1,
              deadline_s: float = LOAD_WAIT_S) -> int:
    """Every statement of a bench half goes to ``node``, which must lead
    (gv$px_exchange and gv$sql_audit are the coordinator's): wait for a
    leader and raise unless it is ``node`` -> ``node``."""
    ldr = c.leader(deadline_s)
    if ldr != node:
        raise AssertionError(f"node {ldr} leads; the bench's statements "
                             f"go to node {node}")
    return node


def take_lead(c: ClusterClient, node: int = 1,
              deadline_s: float = LOAD_WAIT_S) -> int:
    """Wait for a leader; where it is not ``node`` (an election under a
    loaded host moved the lead off the bootstrap node before the first
    statement), ``node`` campaigns through the ``disk.takeover`` verb
    until it leads -> ``node``."""
    ldr = c.leader(deadline_s)
    if ldr != node:
        def won():
            c.clients[node].call("disk.takeover", from_node=ldr,
                                 _deadline_s=deadline_s)
            return c.leader(deadline_s) == node

        wait_for(won, deadline_s,
                 f"node {node} to take the lead from node {ldr}")
    return node


def load_slice(c: ClusterClient, n_rows: int, node: int = 1,
               batch: int = SLICE_BATCH,
               deadline_s: float = LOAD_WAIT_S) -> dict:
    """The reference's cluster load (``trace_bench.py:150-162``):
    ``node`` made leader (``take_lead``), CREATE TABLE lineitem and
    ``batch``-row INSERTs of the slice (seed 1) on ``node``, then the
    followers' weak counts awaited (``chaos_bench.py::wait_converged``)
    -> the seconds of each."""
    cols = planes.gen(n_rows)
    take_lead(c, node, deadline_s)
    t0 = time.monotonic()
    c.execute(node, planes.CREATE_SQL, deadline_s=deadline_s)
    for s in range(0, n_rows, batch):
        c.execute(node, planes.insert_sql(cols, s, min(s + batch, n_rows)),
                  deadline_s=deadline_s)
    load_s = time.monotonic() - t0
    converge_s = c.wait_count("lineitem", n_rows,
                              [i for i in c.clients if i != node],
                              deadline_s=deadline_s)
    return {"rows": n_rows, "load_s": round(load_s, 3),
            "converge_s": round(converge_s, 3)}


def run_half(fn, root: str, device: str = "cuda",
             slice_rows: int | None = None):
    """Boot a bench cluster of the port's nodes under ``root``, make node
    1 the leader, load ``slice_rows`` rows of the slice (none when None)
    -> ``fn(c, load)`` with ``load_slice``'s record (None when nothing
    was loaded); the nodes are closed on the way out, as each reference
    half kills its own."""
    c = boot(root, device)
    try:
        take_lead(c)
        load = None if slice_rows is None else load_slice(c, slice_rows)
        return fn(c, load)
    finally:
        c.close()

