"""The port's integrity primitives and single-node scrub against the JAX
package's: segment round trips and chunk crcs, the order- and
layout-independent logical table digest (with a poisoned-lane case:
the filler under a NULL lane must not count), the byte digests, the
bit-flip matrix at boot (segment, manifest, slog), the boot quarantine
policy, and ``Scrubber.run_once`` over one tenant — detect, quarantine,
rewrite from the resident copy — with its ``gv$scrub`` rows and
``scrub.*`` metrics.  The cases mirror ``tests/test_scrub.py`` (54-290,
391-485); each runs once per package and holds the records equal."""

from __future__ import annotations

import glob
import os
import time
import types

import numpy as np
import pytest
import torch

from torch_pair import J, T, both, outcome

torch.set_num_threads(2)


def _mk_segment(P, n=1000, chunk_rows=256):
    rng = np.random.default_rng(0)
    arrays = {"k": np.arange(n, dtype=np.int64),
              "v": rng.integers(0, 100, n),
              "s": np.array([f"row{i % 17}" for i in range(n)],
                            dtype=object)}
    types_ = {"k": P.SqlType.int_(), "v": P.SqlType.int_(),
              "s": P.SqlType.string()}
    valids = {"v": rng.random(n) > 0.1}
    return P.Segment.build(1, 2, arrays, types_, valids,
                           chunk_rows=chunk_rows), arrays


# ---------------------------------------------------------------------------
# digests and chunk crcs
# ---------------------------------------------------------------------------


def _scn_roundtrip(P, root):
    root.mkdir(parents=True)
    seg, arrays = _mk_segment(P)
    p = str(root / "t_1.npz")
    seg.save(p)
    a, v = P.Segment.load(p).decode()
    assert (a["k"] == arrays["k"]).all() and (a["s"] == arrays["s"]).all()
    ec = seg.columns["v"][0]
    return [P.integrity.chunk_crc(ec.payload, ec.valid, ec.encoding, ec.n),
            a["v"][v["v"]].tolist()]


def test_segment_roundtrip_and_chunk_crc(tmp_path):
    both(_scn_roundtrip, tmp_path)


def _scn_chunk_crc_tamper(P, _root):
    seg, _ = _mk_segment(P, n=64)
    ec = seg.columns["v"][0]
    base = P.integrity.chunk_crc(ec.payload, ec.valid, ec.encoding, ec.n)
    tampered = {k: np.array(v, copy=True) for k, v in ec.payload.items()}
    flat = tampered[next(iter(tampered))].reshape(-1)
    flat[0] ^= np.asarray(1, dtype=flat.dtype)
    t1 = P.integrity.chunk_crc(tampered, ec.valid, ec.encoding, ec.n)
    v2 = ec.valid.copy()
    v2[0] = ~v2[0]
    t2 = P.integrity.chunk_crc(ec.payload, v2, ec.encoding, ec.n)
    return [base, t1 != base, t2 != base]


def test_chunk_crc_detects_value_and_validity_change(tmp_path):
    assert both(_scn_chunk_crc_tamper, tmp_path)[1:] == [True, True]


def _scn_table_digest(P, _root):
    _seg, arrays = _mk_segment(P)
    valids = {"v": np.ones(len(arrays["k"]), dtype=bool)}
    d1 = P.integrity.table_digest(arrays, valids)
    perm = np.random.default_rng(3).permutation(len(arrays["k"]))
    d2 = P.integrity.table_digest({k: v[perm] for k, v in arrays.items()},
                                  {"v": valids["v"][perm]})
    mod = {k: v.copy() for k, v in arrays.items()}
    mod["v"][7] += 1
    v3 = {"v": valids["v"].copy()}
    v3["v"][5] = False
    d4 = P.integrity.table_digest(arrays, v3)
    # poisoned lanes: the filler under a NULL lane is noise and must
    # not change the digest
    poisoned = {k: v.copy() for k, v in arrays.items()}
    poisoned["v"][5] = -(1 << 40)
    d5 = P.integrity.table_digest(poisoned, v3)
    vec = {"e": np.arange(12, dtype=np.float32).reshape(4, 3),
           "k": np.arange(4)}
    return [d1, d1 == d2, P.integrity.table_digest(mod, valids) != d1,
            d4 != d1, d5 == d4, P.integrity.table_digest(vec),
            P.integrity.table_digest({})]


def test_table_digest_order_layout_and_null_independent(tmp_path):
    out = both(_scn_table_digest, tmp_path)
    assert out[1:5] == [True, True, True, True]
    assert out[-1] == {"rows": 0, "crc": 0}


def _scn_byte_digests(P, _root):
    I = P.integrity
    return [I.bytes_crc(b"oceanbase"), I.bytes_crc(b""),
            [I._mix64(np.arange(5, dtype=np.uint64)).tolist()],
            I._col_hash(np.array(["a", "b"], dtype=object)).tolist(),
            I._col_hash(np.array([1.5, -0.0])).tolist(),
            I._col_hash(np.array([3, -1], dtype=np.int32)).tolist()]


def test_byte_digests_and_hash_mixers(tmp_path):
    out = both(_scn_byte_digests, tmp_path)
    assert out[0] != out[1]


def _scn_prune_quarantine(P, root):
    root.mkdir(parents=True)
    now = time.time()
    for i in range(12):
        p = root / f"seg_{i}.npz.corrupt.{i:x}"
        p.write_bytes(b"x")
        os.utime(p, (now - 100 + i, now - 100 + i))
    (root / "old.npz.corrupt.0").write_bytes(b"x")
    os.utime(root / "old.npz.corrupt.0", (now - 10 ** 8, now - 10 ** 8))
    P.integrity.prune_quarantine(str(root), keep=5)
    newest = sorted(os.listdir(root))
    P.integrity.prune_quarantine(str(root), keep=20, max_age_s=50)
    return [newest, sorted(os.listdir(root))]


def test_prune_quarantine_keeps_the_newest(tmp_path):
    newest, young = both(_scn_prune_quarantine, tmp_path)
    assert newest == sorted(f"seg_{i}.npz.corrupt.{i:x}"
                            for i in range(7, 12))
    assert young == []


# ---------------------------------------------------------------------------
# the bit-flip matrix at boot
# ---------------------------------------------------------------------------


def _seed_db(P, root):
    db = P.db(root)
    s = db.session()
    s.execute("create table t (k int primary key, v int)")
    s.execute("insert into t values " +
              ", ".join(f"({i}, {i * 3})" for i in range(200)))
    db.checkpoint()
    return db, s


def _sysdata(root):
    return os.path.join(str(root), "tenants", "sys", "data")


def _flip_covered_segment(P, path):
    from test_torch_disk_faults import _flip_segment

    return _flip_segment(P, path)


def _scn_bitflip_boot(P, root, artifact):
    db, s = _seed_db(P, root / "db")
    if artifact == "slog":
        s.execute("create table u (k int primary key)")
    db.close()
    data = _sysdata(root / "db")
    if artifact == "segment":
        _flip_covered_segment(
            P, glob.glob(os.path.join(data, "segments", "t_*.npz"))[0])
    elif artifact == "manifest":
        P.bitflip_file(os.path.join(data, "manifest.json"), seed=5)
    else:
        slog = os.path.join(data, "slog.jsonl")
        with open(slog, "r+b") as f:
            f.seek(20)
            b = f.read(1)
            f.seek(20)
            f.write(bytes([b[0] ^ 0x04]))
    return outcome(P.db, root / "db")


@pytest.mark.parametrize("artifact", ["segment", "manifest", "slog"])
def test_bitflip_detected_at_boot(tmp_path, artifact):
    assert both(_scn_bitflip_boot, tmp_path, artifact) == \
        ("error", "CorruptionError")


def _scn_boot_quarantine(P, root):
    db, _s = _seed_db(P, root / "db")
    db.close()
    seg = glob.glob(os.path.join(_sysdata(root / "db"), "segments",
                                 "t_*.npz"))[0]
    P.bitflip_file(seg, seed=11)
    eng = P.StorageEngine(_sysdata(root / "db"),
                          corrupt_policy="quarantine")
    return [[q["table"] for q in eng.quarantined], os.path.exists(seg),
            len(glob.glob(seg + ".corrupt.*"))]


def test_boot_quarantine_policy(tmp_path):
    assert both(_scn_boot_quarantine, tmp_path) == [["t"], False, 1]


# ---------------------------------------------------------------------------
# Scrubber.run_once over one tenant (the single-node branch)
# ---------------------------------------------------------------------------


def _scrubber(P, db):
    if P is T:
        return db.scrubber()
    t = db.tenant("sys")
    node = types.SimpleNamespace(engine=t.engine, catalog=t.catalog,
                                 node_id=0, peers=None)
    sc = P.scrub.Scrubber(node)
    db.scrub = sc.state          # what a node database wires for gv$scrub
    return sc


def _gv_scrub(s):
    return [r for r in s.execute(
        "select node_id, table_name, phase, segments, peer, mismatches,"
        " note from gv$scrub").rows()]


def _scn_scrub_round(P, root, corrupt):
    db, s = _seed_db(P, root / "db")
    s.execute("create table u (k int primary key, s varchar(10))")
    s.execute("insert into u values (1, 'a'), (2, 'b'), (3, null)")
    db.checkpoint()
    sc = _scrubber(P, db)
    clean = sc.run_once()
    fp = None
    if corrupt:
        fp = P.FaultPlane(seed=17)
        fp.disk("bitflip", kind="segment", count=1)
        db.tenant("sys").engine.faults = fp
        s.execute("insert into t values (5000, 1), (5001, 2)")
        db.checkpoint()               # the next segment flush rots
        db.tenant("sys").engine.faults = None
    summary = sc.run_once()
    again = sc.run_once()
    rows = _gv_scrub(s)
    keys = ("tables", "segments", "corrupt", "mismatch", "repaired",
            "failed", "discarded")
    reads = s.execute("select count(*), sum(v) from t").rows()
    db.close()
    db2 = P.db(root / "db")       # the repaired file boots clean
    reopened = db2.session().execute("select count(*), sum(v) from t") \
        .rows()
    db2.close()
    return [{k: clean[k] for k in keys}, {k: summary[k] for k in keys},
            {k: again[k] for k in keys}, rows, reads, reopened,
            fp.rules()[0]["fired"] if fp else 0]


@pytest.mark.parametrize("corrupt", [False, True])
def test_scrub_round_detects_quarantines_repairs(tmp_path, corrupt):
    clean, summary, again, rows, reads, reopened, fired = both(
        _scn_scrub_round, tmp_path, corrupt)
    assert clean["corrupt"] == [] and clean["repaired"] == []
    phases = [r[2] for r in rows]
    if corrupt:
        assert fired == 1
        assert [c[0] for c in summary["corrupt"]] == ["t"]
        assert summary["repaired"] == ["t"] and summary["failed"] == []
        assert again["corrupt"] == [] and again["repaired"] == []
        assert phases.count("quarantine") == 1
        assert phases.count("repair") == 1
    else:
        assert "quarantine" not in phases
    assert phases.count("verify") == 3
    assert reads == reopened


def test_scrubber_with_peers_names_the_rpc_plane(tmp_path):
    """A scrubber whose node has peers takes the reference's vote path
    over the rpc plane: it asks each peer for ``scrub.checksum`` at its
    own snapshot and applied LSN, and skips a peer that does not
    answer."""
    import types

    db, _s = _seed_db(T, tmp_path / "db")
    sc = db.scrubber()
    t = db.tenant("sys")
    calls = []

    class Peer:
        def call(self, verb, **kw):
            calls.append((verb, sorted(kw)))
            raise ConnectionError("unreachable")

    sc.node.peers = {2: Peer()}
    sc.node.palf = types.SimpleNamespace(
        replica=types.SimpleNamespace(
            applied_lsn=t.wal.replicas[t.wal.leader_id].applied_lsn))
    sc.node.tx = t.tx
    out = sc.run_once()
    assert calls == [("scrub.checksum", ["applied_lsn", "snapshot"])]
    assert out["mismatch"] == [] and out["repaired"] == []
    db.close()


def _scn_gv_scrub_empty(P, root):
    db = P.db(root / "db")
    got = db.session().execute("select count(*) from gv$scrub").rows()
    db.close()
    return got


def test_gv_scrub_empty_single_node(tmp_path):
    assert both(_scn_gv_scrub_empty, tmp_path) == [(0,)]


def test_scrub_metrics_declared():
    for P in (J, T):
        assert P.scrub is not None
        for name in ("scrub.runs", "scrub.segments_verified",
                     "scrub.bytes_verified", "scrub.corruptions",
                     "scrub.digest_mismatches", "scrub.repairs",
                     "scrub.repair_bytes", "scrub.verify_s"):
            assert name in P.metrics.declared(), (P, name)


@pytest.mark.parametrize("sql", ["select * from gv$scrub",
                                 "explain select * from gv$scrub",
                                 "select phase, count(*) from gv$scrub"
                                 " group by phase order by phase"])
def test_gv_scrub_statements_with_a_database(tmp_path, sql):
    """Statements a Database refused before the plane was ported, now
    answered as the reference answers them (after one scrub round)."""
    def scn(P, root):
        db, s = _seed_db(P, root / "db")
        _scrubber(P, db).run_once()
        r = s.execute(sql)
        # an aggregate's output name embeds each binder's column id
        names = [n for n in r.names if not n.startswith("expr")]
        out = (names, r.rowcount) if sql.startswith("explain") else \
            (names, [row for row in r.rows() if not isinstance(row[0],
                                                              float)])
        db.close()
        return out

    names, rows = both(scn, tmp_path)
    if sql.startswith("select *"):
        assert names[:4] == ["ts", "node_id", "table_name", "phase"]


def _scn_repair_table_segments(P, root):
    """The swap a peer repair ends in, fed a staged baseline from a
    second engine: fresh local segment ids, one ``repair_segments`` slog
    record, and a reopen that replays it to the same rows."""
    src = P.StorageEngine(str(root / "peer"))
    eng = P.StorageEngine(str(root / "local"))
    for e, n in ((src, 300), (eng, 120)):
        e.create_table(P.tdef())
        e.bulk_load("t", {"k": np.arange(n), "v": np.arange(n) * 7})
    eng.bulk_load("t", {"k": np.arange(500, 520), "v": np.arange(20)})
    staged = []
    for seg, part in src.tables["t"].tablet.segment_locations():
        dst = str(root / f"stage_{seg.segment_id}")
        seg.save(dst)
        staged.append({"segment_id": seg.segment_id, "level": seg.level,
                       "part": part, "src": dst})
    before = sorted(s.segment_id for s, _ in
                    eng.tables["t"].tablet.segment_locations())
    out = eng.repair_table_segments("t", staged)
    after = sorted(s.segment_id for s, _ in
                   eng.tables["t"].tablet.segment_locations())
    ops = [o["op"] for o in P.engine.read_slog(eng._slog_path())]
    a, _ = eng.tables["t"].tablet.snapshot_arrays(snapshot=2**62)
    eng2 = P.StorageEngine(str(root / "local"))
    a2, _ = eng2.tables["t"].tablet.snapshot_arrays(snapshot=2**62)
    return [out, before, after, ops[-1], int(a["k"].sum()),
            sorted(a2["k"].tolist()) == sorted(a["k"].tolist()),
            [os.path.exists(x["src"]) for x in staged]]


def test_repair_table_segments_swaps_and_replays(tmp_path):
    out = both(_scn_repair_table_segments, tmp_path)
    assert out[0] == {"removed": 2, "installed": 1}
    assert set(out[2]).isdisjoint(out[1]) and out[3] == "repair_segments"
    assert out[4] == sum(range(300)) and out[5] and out[6] == [False]
