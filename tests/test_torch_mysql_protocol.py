"""The port's MySQL wire protocol against the JAX package's on the CPU.

The same statements go through both packages' ``MySQLServer`` with one
raw-socket client (a copy of ``tests/test_mysql_protocol.py``'s
``MiniClient`` that also keeps each response's packets).  The result-set
packets are byte-equal apart from the greeting's salt, connection id and
version string, and the cells ROADMAP Queue 3 #16 repairs: the reference
writes ``str()`` of ``Result.rows()``, so a DECIMAL goes out through a
float and a DATETIME as its int64 microseconds; the port formats each
cell from ``Result.arrays`` as MySQL does.  Queue 3 #17: the reference
greets with the serving thread's id, which ``KILL QUERY`` cannot reach;
the port greets with the session id.  Then the cases of the reference test
(prepared statements, concurrent sessions, users, SET PASSWORD, TLS),
each on both servers.
"""

import hashlib
import os
import re
import socket
import stat
import struct
import threading
import time
from decimal import Decimal

import pytest
import torch

from oceanbase_tpu.server.mysql_protocol import MySQLServer as JMySQLServer
from oceanbase_tpu_torch.server import mysql_protocol as tproto
from oceanbase_tpu_torch.server.database import Database
from oceanbase_tpu_torch.server.mysql_protocol import MySQLServer
from test_torch_database import _jdb
from test_torch_sql_frontend import align_colids

torch.set_num_threads(2)

T_NEWDECIMAL = 246


class MiniClient:
    """Just enough of the 4.1 protocol to drive the server; ``raw``
    keeps the packets of the last response."""

    def __init__(self, host, port, user="root", password=""):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.seq = 0
        self.user = user
        self.password = password
        self.raw: list[bytes] = []
        self._handshake()

    def _read_packet(self):
        hdr = self._read_n(4)
        (ln,) = struct.unpack("<I", hdr[:3] + b"\x00")
        self.seq = hdr[3] + 1
        return self._read_n(ln)

    def _read_n(self, n):
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("closed")
            buf += part
        return buf

    def _send(self, payload):
        self.sock.sendall(struct.pack("<I", len(payload))[:3] +
                          bytes([self.seq & 0xFF]) + payload)
        self.seq += 1

    def _handshake(self):
        greeting = self._read_packet()
        assert greeting[0] == 0x0A
        end = greeting.index(b"\x00", 1)
        assert b"oceanbase-tpu" in greeting[1:end]
        self.connection_id = struct.unpack_from("<I", greeting, end + 1)[0]
        p = end + 1 + 4
        salt = greeting[p:p + 8]
        rest = greeting[p + 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10:]
        salt += rest[:rest.index(b"\x00")]
        if self.password:
            sha_pw = hashlib.sha1(self.password.encode()).digest()
            stage2 = hashlib.sha1(sha_pw).digest()
            mask = hashlib.sha1(salt[:20] + stage2).digest()
            token = bytes(a ^ b for a, b in zip(sha_pw, mask))
        else:
            token = b""
        caps = 0x0200 | 0x8000  # PROTOCOL_41 | SECURE_CONNECTION
        self._send(struct.pack("<IIB", caps, 1 << 24, 0x21) +
                   b"\x00" * 23 + self.user.encode() + b"\x00" +
                   bytes([len(token)]) + token)
        ok = self._read_packet()
        if ok[0] == 0xFF:
            code = struct.unpack_from("<H", ok, 1)[0]
            raise PermissionError(f"auth failed: {code}")
        assert ok[0] == 0x00, ok

    @staticmethod
    def _lenenc(buf, pos):
        c = buf[pos]
        if c < 251:
            return c, pos + 1
        if c == 0xFC:
            return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
        if c == 0xFD:
            return struct.unpack("<I", buf[pos + 1:pos + 4] + b"\x00")[0], \
                pos + 4
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9

    def _response(self):
        """Read one response; -> its packets."""
        first = self._read_packet()
        pkts = [first]
        if first[0] in (0x00, 0xFF):
            return pkts
        ncols, _ = self._lenenc(first, 0)
        for _ in range(ncols + 1):   # column definitions, EOF
            pkts.append(self._read_packet())
        while True:
            pkts.append(self._read_packet())
            if pkts[-1][0] == 0xFE and len(pkts[-1]) < 9:
                return pkts

    def query(self, sql):
        self.seq = 0
        self._send(b"\x03" + sql.encode())
        self.raw = self._response()
        first = self.raw[0]
        if first[0] == 0x00:
            affected, _ = self._lenenc(first, 1)
            return {"ok": True, "affected": affected}
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise RuntimeError(f"server error {code}: "
                               f"{first[9:].decode(errors='replace')}")
        return {"ok": True, "rows": [text_row(p) for p in self.raw[
            2 + self._lenenc(first, 0)[0]:-1]]}

    def ping(self):
        self.seq = 0
        self._send(b"\x0e")
        return self._read_packet()[0] == 0x00

    def close(self):
        try:
            self.seq = 0
            self._send(b"\x01")
        except Exception:
            pass
        self.sock.close()


def text_row(pkt):
    pos, row = 0, []
    while pos < len(pkt):
        if pkt[pos] == 0xFB:
            row.append(None)
            pos += 1
        else:
            ln, pos = MiniClient._lenenc(pkt, pos)
            row.append(pkt[pos:pos + ln].decode())
            pos += ln
    return tuple(row)


def column_def(pkt):
    """-> (name, type, decimals) of a column-definition packet."""
    pos, strs = 0, []
    for _ in range(6):
        ln, pos = MiniClient._lenenc(pkt, pos)
        strs.append(pkt[pos:pos + ln])
        pos += ln
    mtype = pkt[pos + 1 + 2 + 4]
    decimals = pkt[pos + 1 + 2 + 4 + 1 + 2]
    return strs[4].decode(), mtype, decimals


def mysql_decimal_ok(text, decimals):
    """MySQL's text of a DECIMAL(_, decimals): exactly ``decimals``
    digits after the point."""
    pat = r"-?\d+" + (rf"\.\d{{{decimals}}}" if decimals else "")
    return re.fullmatch(pat, text) is not None


@pytest.fixture()
def servers(tmp_path):
    """(reference server, port server), each over its own database."""
    jdb = _jdb(tmp_path / "jax")
    tdb = Database(str(tmp_path / "port"), device="cpu")
    js, ts = JMySQLServer(jdb).start(), MySQLServer(tdb).start()
    yield js, ts
    for srv, db in ((js, jdb), (ts, tdb)):
        srv.stop()
        db.close()


def _both(servers, **kw):
    return [MiniClient(s.host, s.port, **kw) for s in servers]


# ---------------------------------------------------------------------------
# packets against the reference's
# ---------------------------------------------------------------------------

SCRIPT = [
    "create table t (k int primary key, v decimal(10,2), name varchar(20), "
    "d date, x double)",
    "insert into t values (1, 10.25, 'ann', '1994-01-05', 0.5), "
    "(2, 20.75, null, '1995-03-01', -1.25), (3, -3.5, 'bob', null, 2.0)",
    "select k, name, d, x from t order by k",
    "select k, v from t order by k",
    "select sum(v) as total, count(*) as n from t",
    "select name, count(*) as c from t group by name order by name",
    "select k, v * 2 as w from t where v > 0 order by k",
    "update t set x = x * 2 where k >= 2",
    "delete from t where k = 3",
    "select * from t where k > 100",
    "select nope from t",
    "select k, x, d from t order by k",
    "describe t",
]


def test_result_packets_equal_the_reference(servers):
    """Every response of the script is byte-equal to the reference's,
    but the NEWDECIMAL cells (#16): the port's has exactly the column's
    decimals and the same value as the reference's float text."""
    jc, tc = _both(servers)
    n16 = 0
    for sql in SCRIPT:
        align_colids()
        out = []
        for c in (jc, tc):
            try:
                c.query(sql)
            except RuntimeError:
                pass
            out.append(c.raw)
        jraw, traw = out
        assert len(jraw) == len(traw), sql
        if jraw[0][0] == 0xFF:
            # ERR: the same code, state and exception type
            assert traw[0][:9] == jraw[0][:9], sql
            assert traw[0][9:].split(b":")[0] == \
                jraw[0][9:].split(b":")[0], sql
            continue
        if jraw[0][0] == 0x00:
            assert traw == jraw, sql
            continue
        ncols = jraw[0][0]
        assert traw[:ncols + 2] == jraw[:ncols + 2], sql  # defs + EOF
        assert traw[-1] == jraw[-1]
        defs = [column_def(p) for p in jraw[1:ncols + 1]]
        for jp, tp in zip(jraw[ncols + 2:-1], traw[ncols + 2:-1]):
            if jp == tp:
                continue
            for (name, mtype, dec), jv, tv in zip(defs, text_row(jp),
                                                  text_row(tp)):
                if jv == tv:
                    continue
                assert mtype == T_NEWDECIMAL, (sql, name, jv, tv)
                assert mysql_decimal_ok(tv, dec), (sql, tv)
                assert float(tv) == pytest.approx(float(jv), rel=1e-12)
                n16 += 1
    # the reference drops trailing zeros: 10.25 and 20.75 stay, -3.50,
    # 27.50 (the sum) and 20.50, 41.50 (v * 2) do not
    assert n16 == 4
    assert tc.query("select k, v from t order by k")["rows"] == \
        [("1", "10.25"), ("2", "20.75")]
    jc.close()
    tc.close()


CELLS_SCRIPT = [
    "create table t (k int primary key, v decimal(18,6), p decimal(10,2))",
    "insert into t values (1, 12345678901.123456, 10.50), "
    "(2, -0.000001, -0.50)",
    "create table d (k int primary key, ts datetime, b bool)",
    "insert into d values (1, 757771200000000, true)",
]


def test_decimal_datetime_bool_cells_are_mysql_text(servers):
    """ROADMAP Queue 3 #16: the reference's text of DECIMAL, DATETIME and
    BOOL cells beside the port's, which is MySQL's."""
    jc, tc = _both(servers)
    for sql in CELLS_SCRIPT:
        jc.query(sql)
        tc.query(sql)
    q1 = "select k, v, p from t order by k"
    q2 = "select k, ts, b from d"
    assert jc.query(q1)["rows"] == [
        ("1", "12345678901.123455", "10.5"), ("2", "-1e-06", "-0.5")]
    assert tc.query(q1)["rows"] == [
        ("1", "12345678901.123456", "10.50"), ("2", "-0.000001", "-0.50")]
    assert jc.query(q2)["rows"] == [("1", "757771200000000", "True")]
    assert tc.query(q2)["rows"] == [("1", "1994-01-05 12:00:00", "1")]
    # the column definitions stay the reference's
    jc.query(q2)
    jdefs = jc.raw[:5]
    tc.query(q2)
    assert tc.raw[:5] == jdefs
    jc.close()
    tc.close()


@pytest.mark.parametrize("scaled,scale,text", [
    (0, 2, "0.00"), (5, 2, "0.05"), (-5, 2, "-0.05"), (1050, 2, "10.50"),
    (12345678901123456, 6, "12345678901.123456"), (-1, 6, "-0.000001"),
    (42, 0, "42"), (-42, 0, "-42"),
    (99999999999999999, 4, "9999999999999.9999"),
])
def test_decimal_text_is_exact(scaled, scale, text):
    assert tproto.format_decimal(scaled, scale) == text
    assert Decimal(text) == Decimal(scaled).scaleb(-scale)


@pytest.mark.parametrize("us,text", [
    (0, "1970-01-01 00:00:00"),
    (757771200000000, "1994-01-05 12:00:00"),
    (757771200000001, "1994-01-05 12:00:00.000001"),
    (-1, "1969-12-31 23:59:59.999999"),
    (951825599999999, "2000-02-29 11:59:59.999999"),
])
def test_datetime_text(us, text):
    assert tproto.format_datetime(us) == text


# ---------------------------------------------------------------------------
# ROADMAP Queue 3 #17: the greeting's connection id reaches KILL
# ---------------------------------------------------------------------------


def _wait(cond, timeout_s=20.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError("timed out waiting")
        time.sleep(0.02)


def test_kill_query_by_greeting_id(servers):
    jsrv, tsrv = servers
    # the reference greets with its thread's id: KILL QUERY cannot reach it
    ja, jb = _both((jsrv, jsrv))
    with pytest.raises(RuntimeError, match="KeyError: 'unknown session id"):
        jb.query(f"kill query {ja.connection_id}")
    ja.close()
    jb.close()

    a, b = _both((tsrv, tsrv))
    assert a.connection_id != b.connection_id
    a.query("create table t (k int primary key, v int)")
    a.query("insert into t values (1, 1), (2, 2)")
    a.query("create procedure spin(in n int) begin declare i int default "
            "0; while i < n do select count(*) from t; set i = i + 1; "
            "end while; end")
    res = {}

    def victim():
        try:
            a.query("call spin(1000000)")
        except RuntimeError as e:
            res["err"] = str(e)

    th = threading.Thread(target=victim)
    th.start()

    def running():
        rows = b.query("show processlist")["rows"]
        return (str(a.connection_id), "RUNNING",
                "call spin(1000000)") in rows

    _wait(running)
    t0 = time.monotonic()
    assert b.query(f"kill query {a.connection_id}")["affected"] == 1
    th.join(20)
    assert not th.is_alive()
    assert "QueryKilled" in res["err"]
    assert time.monotonic() - t0 < 10
    assert a.query("select count(*) from t")["rows"] == [("2",)]
    # plain KILL evicts the connection's session
    assert b.query(f"kill {a.connection_id}")["affected"] == 1
    with pytest.raises(RuntimeError, match="QueryKilled"):
        a.query("select 1")
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# the cases of tests/test_mysql_protocol.py, on both servers
# ---------------------------------------------------------------------------


def _prepare(c, sql):
    c.seq = 0
    c._send(b"\x16" + sql.encode())
    ok = c._read_packet()
    assert ok[0] == 0x00
    stmt_id, _ncols, nparams = struct.unpack_from("<IHH", ok, 1)
    for _ in range(nparams):
        c._read_packet()
    if nparams:
        assert c._read_packet()[0] == 0xFE
    return stmt_id, nparams


def _execute(c, stmt_id, value):
    c.seq = 0
    c._send(b"\x17" + struct.pack("<IBI", stmt_id, 0, 1) + b"\x00" +
            b"\x01" + struct.pack("<H", 8) + struct.pack("<q", value))
    return c._response()


def _binary_rows(pkts):
    ncols = pkts[0][0]
    rows = []
    for pkt in pkts[ncols + 2:-1]:
        assert pkt[0] == 0x00  # binary row header
        pos = 1 + (ncols + 2 + 7) // 8
        k = struct.unpack_from("<q", pkt, pos)[0]
        pos += 8
        ln, pos = MiniClient._lenenc(pkt, pos)
        rows.append((k, pkt[pos:pos + ln].decode()))
    return rows


def test_prepared_statements_binary_protocol(servers):
    jc, tc = _both(servers)
    got = []
    for c in (jc, tc):
        c.query("create table p (k int primary key, v decimal(10,2))")
        c.query("insert into p values (1, 1.50), (2, 2.25), (3, 3.75)")
        align_colids()
        stmt_id, nparams = _prepare(
            c, "select k, v from p where k >= ? order by k")
        assert nparams == 1
        got.append((_execute(c, stmt_id, 2), _execute(c, stmt_id, 1)))
        # COM_STMT_CLOSE then re-execute -> clean error
        c.seq = 0
        c._send(b"\x19" + struct.pack("<I", stmt_id))
        assert _execute(c, stmt_id, 1)[0][0] == 0xFF
        assert c.ping()
        c.close()
    (j2, j1), (t2, t1) = got
    assert t2 == j2  # no #16 cell: 2.25 and 3.75 print alike
    assert _binary_rows(t2) == [(2, "2.25"), (3, "3.75")]
    assert _binary_rows(j1)[0] == (1, "1.5")       # #16 (reference)
    assert _binary_rows(t1) == [(1, "1.50"), (2, "2.25"), (3, "3.75")]
    assert t1[:4] == j1[:4]  # column count, definitions and EOF


@pytest.mark.parametrize("which", ["reference", "port"])
def test_wire_two_concurrent_sessions(servers, which):
    srv = servers[which == "port"]
    c1, c2 = _both((srv, srv))
    c1.query("create table s (k int primary key, v int)")
    c1.query("insert into s values (1, 1)")
    c1.query("begin")
    c1.query("update s set v = 2 where k = 1")
    assert c2.query("select v from s")["rows"] == [("1",)]
    c1.query("commit")
    assert c2.query("select v from s")["rows"] == [("2",)]
    c1.close()
    c2.close()


@pytest.mark.parametrize("which", ["reference", "port"])
def test_auth_rejects_bad_password(servers, which):
    srv = servers[which == "port"]
    c = MiniClient(srv.host, srv.port)
    assert c.query("create user alice identified by 'secret'")["ok"]
    c.close()
    c2 = MiniClient(srv.host, srv.port, user="alice", password="secret")
    assert c2.ping()
    c2.close()
    for user, pw in (("alice", "wrong"), ("mallory", "x"), ("root", "nope")):
        with pytest.raises(PermissionError):
            MiniClient(srv.host, srv.port, user=user, password=pw)


def test_users_json_equal_and_across_restart(servers, tmp_path):
    """The same user statements write byte-equal users.json files; a
    port Database reopened on either file authenticates those users."""
    for srv in servers:
        c = MiniClient(srv.host, srv.port)
        c.query("create user bob identified by 'pw1'")
        c.query("create user eve identified by ''")
        c.query("set password for bob = 'pw2'")
        c.query("drop user eve")
        c.close()
    files = [open(os.path.join(s.database.root, "users.json"), "rb").read()
             for s in servers]
    assert files[0] == files[1]
    # fresh port roots holding the users.json each package wrote (the
    # servers' own databases stay open until the fixture closes them)
    for name, data in zip(("from_jax", "from_port"), files):
        (tmp_path / name).mkdir()
        (tmp_path / name / "users.json").write_bytes(data)
    for root in (str(tmp_path / "from_jax"), str(tmp_path / "from_port")):
        db2 = Database(root, device="cpu")
        assert set(db2.users) == {"root", "bob"}
        srv = MySQLServer(db2).start()
        c = MiniClient(srv.host, srv.port, user="bob", password="pw2")
        assert c.ping()
        c.close()
        with pytest.raises(PermissionError):
            MiniClient(srv.host, srv.port, user="bob", password="pw1")
        srv.stop()
        db2.close()


@pytest.mark.parametrize("which", ["reference", "port"])
def test_set_password(servers, which):
    srv = servers[which == "port"]
    c = MiniClient(srv.host, srv.port)
    c.query("create user carol identified by 'old'")
    c.query("set password for carol = 'new'")
    c.close()
    with pytest.raises(PermissionError):
        MiniClient(srv.host, srv.port, user="carol", password="old")
    c2 = MiniClient(srv.host, srv.port, user="carol", password="new")
    assert c2.ping()
    c2.close()


@pytest.mark.parametrize("which", ["reference", "port"])
def test_tls_upgrade(servers, which):
    """SSLRequest upgrade: the TLS handshake mid-protocol, then the login
    and queries over the encrypted channel."""
    import ssl

    srv = servers[which == "port"]
    c = MiniClient.__new__(MiniClient)
    c.sock = socket.create_connection((srv.host, srv.port), timeout=30)
    c.seq = 0
    c.user, c.password = "root", ""
    greeting = c._read_packet()
    p = greeting.index(b"\x00", 1) + 1 + 4 + 8 + 1
    assert struct.unpack_from("<H", greeting, p)[0] & 0x800
    caps = 0x0200 | 0x8000 | 0x800
    c._send(struct.pack("<IIB", caps, 1 << 24, 0x21) + b"\x00" * 23)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    c.sock = ctx.wrap_socket(c.sock)
    assert c.sock.version() is not None
    c._send(struct.pack("<IIB", caps, 1 << 24, 0x21) + b"\x00" * 23 +
            b"root\x00" + b"\x00")
    assert c._read_packet()[0] == 0x00
    c.query("create table tt (k int primary key)")
    c.query("insert into tt values (1), (2)")
    assert c.query("select count(*) from tt")["rows"] == [("2",)]
    c.close()
    key = os.path.join(srv.database.root, "tls", "server-key.pem")
    assert stat.S_IMODE(os.stat(key).st_mode) == 0o600


def test_tls_key_file_mode(tmp_path):
    from oceanbase_tpu_torch.server.tls import ensure_server_credentials

    cert_p, key_p = ensure_server_credentials(str(tmp_path))
    assert os.path.exists(cert_p)
    assert stat.S_IMODE(os.stat(key_p).st_mode) == 0o600


def test_tls_key_file_mode_openssl_fallback(tmp_path):
    import shutil

    from oceanbase_tpu_torch.server.tls import _openssl_credentials

    if shutil.which("openssl") is None:
        pytest.skip("no openssl binary on this host")
    tdir = str(tmp_path / "tls")
    os.makedirs(tdir)
    cert_p = os.path.join(tdir, "server-cert.pem")
    key_p = os.path.join(tdir, "server-key.pem")
    _openssl_credentials(tdir, cert_p, key_p)
    assert stat.S_IMODE(os.stat(key_p).st_mode) == 0o600


def test_server_stop_closes_live_connections(tmp_path):
    """stop() closes the connections still open and waits for their
    threads; their sessions leave the registry."""
    db = Database(str(tmp_path / "db"), device="cpu")
    srv = MySQLServer(db).start()
    c = MiniClient(srv.host, srv.port)
    assert c.ping()
    assert len(db.ash.sessions()) == 1
    srv.stop()
    assert db.ash.sessions() == {}
    with pytest.raises((ConnectionError, OSError)):
        c.query("select 1")
    db.close()


def test_server_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Database(str(tmp_path / "db"))
    db = Database(str(tmp_path / "db2"), device="cpu")
    srv = MySQLServer(db).start()
    c = MiniClient(srv.host, srv.port)
    c.query("create table t (k int primary key)")
    assert db.catalog.table_data("t").device.type == "cpu"
    c.close()
    srv.stop()
    db.close()
