"""MySQL wire-protocol frontend.

Port of ``oceanbase_tpu/server/mysql_protocol.py`` (≙ the obmysql
protocol stack + command processors: deps/oblib/src/rpc/obmysql,
src/observer/mysql — obmp_query, result drivers serializing rows to
MySQL packets, ob_sync_plan_driver.cpp).

Protocol 4.1: handshake v10 with mysql_native_password verified against
the database's user store (≙ obsm_handler auth), the TLS upgrade on an
SSLRequest (``server/tls.py``), COM_QUERY / COM_PING / COM_INIT_DB /
COM_QUIT, the binary protocol (COM_STMT_PREPARE / EXECUTE / CLOSE /
RESET), OK/ERR/EOF packets, column definitions and text and binary
result rows.  One engine Session per connection, on the database's
device; a thread per connection (≙ one ObThWorker serving the session).
A response is queued packet by packet and written in one send, on a
TCP_NODELAY socket (the reference writes each packet on its own, so the
last segment of a response can wait out a delayed ACK).

Two repairs over the reference (ROADMAP Queue 3 #16 and #17):

- cells are formatted from ``Result.arrays``, not from ``Result.rows()``
  (which turns a DECIMAL into a float and leaves a DATETIME as its
  int64 microseconds): a DECIMAL goes out exactly, from its scaled int
  with ``scale`` digits; a DATETIME as ``YYYY-MM-DD HH:MM:SS[.ffffff]``;
  a DATE as ``YYYY-MM-DD``; a BOOL as ``0``/``1``; NULL as 0xfb.  The
  binary protocol's text-shipped cells get the same text;
- the greeting's connection id is the connection's ``session_id``, the
  id ``KILL [QUERY]`` and SHOW PROCESSLIST use (the reference sends the
  serving thread's id, which no KILL can reach).
"""

from __future__ import annotations

import hashlib
import os
import socket
import socketserver
import struct
import threading

import numpy as np

from oceanbase_tpu_torch.datatypes import DATE_EPOCH, TypeKind, days_to_date

# capability flags
CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SSL = 0x800

SERVER_CAPS = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41 |
               CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH |
               CLIENT_CONNECT_WITH_DB | CLIENT_TRANSACTIONS |
               CLIENT_SSL)

# column types
T_DOUBLE, T_LONGLONG, T_DATE, T_NEWDECIMAL, T_VAR_STRING = 5, 8, 10, 246, 253


def lenenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def _read_lenenc(buf: bytes, pos: int):
    c = buf[pos]
    if c < 251:
        return c, pos + 1
    if c == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if c == 0xFD:
        return struct.unpack("<I", buf[pos + 1:pos + 4] + b"\x00")[0], pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


class _Conn:
    def __init__(self, sock: socket.socket, session):
        self.sock = sock
        self.session = session
        self.seq = 0
        self._stmts: dict[int, tuple] = {}  # stmt_id -> (sql, n_params)
        self._next_stmt = 1
        self._out: list[bytes] = []  # packets not yet written

    # ---- packet framing ------------------------------------------------
    def send(self, payload: bytes):
        """Queue one logical payload; ``flush`` writes the queue (a
        response goes out in one write, not one per row)."""
        while True:
            chunk, payload = payload[:0xFFFFFF], payload[0xFFFFFF:]
            hdr = struct.pack("<I", len(chunk))[:3] + bytes([self.seq & 0xFF])
            self._out.append(hdr + chunk)
            self.seq += 1
            if len(chunk) < 0xFFFFFF:
                break

    def flush(self):
        if self._out:
            data, self._out = b"".join(self._out), []
            self.sock.sendall(data)

    def recv(self) -> bytes | None:
        """Read one logical payload, reassembling >=16MB multi-packet
        sequences (each full 0xFFFFFF chunk continues into the next).
        What was queued for the client is written first."""
        self.flush()
        payload = b""
        while True:
            hdr = self._read_n(4)
            if hdr is None:
                return None
            (ln,) = struct.unpack("<I", hdr[:3] + b"\x00")
            self.seq = hdr[3] + 1
            chunk = self._read_n(ln)
            if chunk is None:
                return None
            payload += chunk
            if ln < 0xFFFFFF:
                return payload

    def _read_n(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                return None
            buf += part
        return buf

    # ---- standard packets ----------------------------------------------
    def send_ok(self, affected=0, insert_id=0):
        self.send(b"\x00" + lenenc_int(affected) + lenenc_int(insert_id) +
                  struct.pack("<HH", 0x0002, 0))

    def send_err(self, code: int, msg: str, state=b"HY000"):
        self.send(b"\xff" + struct.pack("<H", code) + b"#" + state +
                  msg.encode()[:512])

    def send_eof(self):
        self.send(b"\xfe" + struct.pack("<HH", 0, 0x0002))

    # ---- handshake ------------------------------------------------------
    def _tls_context(self):
        try:
            return (self.session.db.tls_context
                    if self.session.db is not None else None)
        except Exception:
            return None  # e.g. cert generation unavailable

    def handshake(self) -> bool:
        # random 20-byte salt, ascii-safe (no NULs — the greeting is
        # NUL-delimited)
        salt = bytes(0x21 + (b % 0x5d) for b in os.urandom(20))
        # only advertise TLS when a usable context exists: clients with
        # ssl-mode=PREFERRED upgrade on seeing the flag and would hard-
        # fail against an in-memory (certless) server
        caps = SERVER_CAPS if self._tls_context() is not None \
            else SERVER_CAPS & ~CLIENT_SSL
        greeting = (
            b"\x0a" + b"5.7.0-oceanbase-tpu\x00" +
            struct.pack("<I", self.session.session_id & 0xFFFFFFFF) +
            salt[:8] + b"\x00" +
            struct.pack("<H", caps & 0xFFFF) +
            b"\x21" +                       # charset utf8
            struct.pack("<H", 0x0002) +     # status
            struct.pack("<H", (caps >> 16) & 0xFFFF) +
            bytes([21]) + b"\x00" * 10 + salt[8:] + b"\x00" +
            b"mysql_native_password\x00"
        )
        self.seq = 0
        self.send(greeting)
        resp = self.recv()
        if resp is None:
            return False
        caps0 = struct.unpack_from("<I", resp, 0)[0] if len(resp) >= 4 \
            else 0
        if caps0 & CLIENT_SSL and len(resp) <= 32:
            # SSLRequest: upgrade the socket to TLS, then read the real
            # login over the encrypted channel (≙ the ussl-hook TLS
            # upgrade on the mysql port, deps/ussl-hook)
            ctx = self._tls_context()
            if ctx is None:
                self.send_err(3159, "server TLS is not configured")
                return False
            self.sock = ctx.wrap_socket(self.sock, server_side=True)
            resp = self.recv()
            if resp is None:
                return False
        user, token = self._parse_handshake_response(resp)
        users = getattr(self.session.db, "users", None) \
            if self.session.db is not None else None
        if not _verify_native_password(users, user, token, salt):
            self.send_err(1045, f"Access denied for user '{user}'",
                          state=b"28000")
            return False
        self.send_ok()
        return True

    @staticmethod
    def _parse_handshake_response(resp: bytes):
        """-> (username, auth_token) from a protocol-4.1 login packet."""
        try:
            caps = struct.unpack_from("<I", resp, 0)[0]
            off = 4 + 4 + 1 + 23  # caps, max packet, charset, reserved
            end = resp.index(b"\x00", off)
            user = resp[off:end].decode("utf-8", "replace")
            off = end + 1
            if caps & CLIENT_SECURE_CONNECTION:
                n = resp[off]
                token = resp[off + 1:off + 1 + n]
            else:
                end = resp.find(b"\x00", off)
                token = resp[off:end if end >= 0 else len(resp)]
            return user, token
        except (IndexError, ValueError, struct.error):
            return "", b""

    # ---- result sets ----------------------------------------------------
    def send_resultset(self, result):
        names = result.names
        self.send(lenenc_int(len(names)))
        for name in names:
            t = result.dtypes.get(name)
            mtype, length, decimals = self._coltype(t)
            payload = (lenenc_str(b"def") + lenenc_str(b"") +
                       lenenc_str(b"") + lenenc_str(b"") +
                       lenenc_str(name.encode()) + lenenc_str(name.encode()) +
                       b"\x0c" + struct.pack("<H", 0x21) +
                       struct.pack("<I", length) + bytes([mtype]) +
                       struct.pack("<H", 0) + bytes([decimals]) + b"\x00\x00")
            self.send(payload)
        self.send_eof()
        cols = [_lenenc_cells(c) for c in _text_columns(result)]
        for row in zip(*cols):
            body = b"".join(row)
            if len(body) >= 0xFFFFFF:
                self.send(body)  # split over several packets
                continue
            self._out.append(len(body).to_bytes(3, "little") +
                             bytes((self.seq & 0xFF,)) + body)
            self.seq += 1
        self.send_eof()

    @staticmethod
    def _coltype(t):
        if t is None:
            return T_VAR_STRING, 255, 0
        if t.kind == TypeKind.DECIMAL:
            return T_NEWDECIMAL, 20, t.scale
        if t.kind in (TypeKind.INT, TypeKind.BOOL):
            return T_LONGLONG, 20, 0
        if t.kind in (TypeKind.FLOAT, TypeKind.DOUBLE):
            return T_DOUBLE, 24, 6
        if t.kind == TypeKind.DATE:
            return T_DATE, 10, 0
        return T_VAR_STRING, 255, 0

    # ---- command loop ----------------------------------------------------
    def serve(self):
        try:
            self._serve()
        finally:
            self.flush()  # a last ERR (refused login) or OK

    def _serve(self):
        if not self.handshake():
            return
        while True:
            self.seq = 0
            pkt = self.recv()
            if pkt is None or not pkt:
                return
            cmd, arg = pkt[0], pkt[1:]
            if cmd == 0x01:               # COM_QUIT
                return
            if cmd == 0x0E:               # COM_PING
                self.send_ok()
                continue
            if cmd == 0x02:               # COM_INIT_DB
                self.send_ok()
                continue
            if cmd == 0x03:               # COM_QUERY
                self._handle_query(arg.decode(errors="replace"))
                continue
            if cmd == 0x16:               # COM_STMT_PREPARE
                self._stmt_prepare(arg.decode(errors="replace"))
                continue
            if cmd == 0x17:               # COM_STMT_EXECUTE
                self._stmt_execute(arg)
                continue
            if cmd == 0x19:               # COM_STMT_CLOSE (no response)
                if len(arg) >= 4:
                    self._stmts.pop(struct.unpack_from("<I", arg)[0], None)
                continue
            if cmd == 0x1A:               # COM_STMT_RESET
                self.send_ok()
                continue
            self.send_err(1047, f"unsupported command {cmd:#x}")

    # ---- prepared statements (binary protocol) --------------------------
    def _stmt_prepare(self, sql: str):
        """COM_STMT_PREPARE: parse once, report parameter count
        (≙ the PS cache keyed per session)."""
        try:
            from oceanbase_tpu_torch.sql.parser import Parser

            p = Parser(sql)
            p.parse()
            n_params = p.n_params
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self.send_err(1064, f"{type(e).__name__}: {e}")
            return
        stmt_id = self._next_stmt
        self._next_stmt += 1
        self._stmts[stmt_id] = (sql, n_params, [T_VAR_STRING] * n_params)
        # PREPARE-OK: stmt id, 0 result columns (computed at execute),
        # n params, warnings
        self.send(b"\x00" + struct.pack("<IHHBH", stmt_id, 0, n_params,
                                        0, 0))
        for _ in range(n_params):
            payload = (lenenc_str(b"def") + lenenc_str(b"") * 3 +
                       lenenc_str(b"?") + lenenc_str(b"") +
                       b"\x0c" + struct.pack("<H", 0x21) +
                       struct.pack("<I", 255) + bytes([T_VAR_STRING]) +
                       struct.pack("<H", 0) + b"\x00\x00\x00")
            self.send(payload)
        if n_params:
            self.send_eof()

    def _stmt_execute(self, arg: bytes):
        if len(arg) < 9:
            self.send_err(1064, "malformed COM_STMT_EXECUTE")
            return
        stmt_id = struct.unpack_from("<I", arg)[0]
        ent = self._stmts.get(stmt_id)
        if ent is None:
            self.send_err(1243, f"unknown prepared statement {stmt_id}")
            return
        sql, n_params, bound_types = ent
        pos = 9  # id(4) + flags(1) + iteration_count(4)
        params: list = []
        try:
            if n_params:
                nb = (n_params + 7) // 8
                null_bitmap = arg[pos:pos + nb]
                pos += nb
                new_params_bound = arg[pos]
                pos += 1
                if new_params_bound:
                    types = []
                    for _ in range(n_params):
                        types.append(struct.unpack_from("<H", arg, pos)[0])
                        pos += 2
                    # bound types persist PER STATEMENT for re-executes
                    self._stmts[stmt_id] = (sql, n_params, types)
                else:
                    types = bound_types
                for i in range(n_params):
                    if null_bitmap[i // 8] & (1 << (i % 8)):
                        params.append(None)
                        continue
                    t = types[i] & 0xFF
                    v, pos = self._read_binary_value(arg, pos, t)
                    params.append(v)
        except (IndexError, struct.error) as e:
            self.send_err(1064, f"malformed binary parameters: {e}")
            return
        try:
            result = self.session.execute(sql, params=params)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self.send_err(1064, f"{type(e).__name__}: {e}")
            return
        if result.names:
            self._send_binary_resultset(result)
        else:
            self.send_ok(affected=result.rowcount)

    @staticmethod
    def _read_binary_value(buf: bytes, pos: int, mtype: int):
        if mtype in (1,):          # TINY
            return struct.unpack_from("<b", buf, pos)[0], pos + 1
        if mtype in (2,):          # SHORT
            return struct.unpack_from("<h", buf, pos)[0], pos + 2
        if mtype in (3, 9):        # LONG / INT24
            return struct.unpack_from("<i", buf, pos)[0], pos + 4
        if mtype == T_LONGLONG:
            return struct.unpack_from("<q", buf, pos)[0], pos + 8
        if mtype == 4:             # FLOAT
            return struct.unpack_from("<f", buf, pos)[0], pos + 4
        if mtype == T_DOUBLE:
            return struct.unpack_from("<d", buf, pos)[0], pos + 8
        if mtype in (7, 10, 12):   # TIMESTAMP / DATE / DATETIME (packed)
            ln = buf[pos]
            pos += 1
            if ln == 0:
                return "0000-00-00", pos
            y, mo, d = struct.unpack_from("<HBB", buf, pos)
            out = f"{y:04d}-{mo:02d}-{d:02d}"
            if ln >= 7:
                h, mi, sec = struct.unpack_from("<BBB", buf, pos + 4)
                out += f" {h:02d}:{mi:02d}:{sec:02d}"
            return out, pos + ln
        if mtype == 11:            # TIME (packed)
            ln = buf[pos]
            pos += 1
            if ln == 0:
                return "00:00:00", pos
            neg, _days, h, mi, sec = struct.unpack_from("<BIBBB", buf, pos)
            sign = "-" if neg else ""
            return f"{sign}{h:02d}:{mi:02d}:{sec:02d}", pos + ln
        # everything else ships as length-encoded string
        ln, pos = _read_lenenc(buf, pos)
        raw = buf[pos:pos + ln]
        return raw.decode(errors="replace"), pos + ln

    def _send_binary_resultset(self, result):
        names = result.names
        self.send(lenenc_int(len(names)))
        mtypes = []
        for name in names:
            t = result.dtypes.get(name)
            mtype, length, decimals = self._coltype(t)
            if mtype == T_DATE:
                # binary DATE rows use a packed format we don't emit;
                # advertise VAR_STRING so the lenenc text value parses
                mtype = T_VAR_STRING
            mtypes.append((mtype, t))
            payload = (lenenc_str(b"def") + lenenc_str(b"") * 3 +
                       lenenc_str(name.encode()) + lenenc_str(name.encode()) +
                       b"\x0c" + struct.pack("<H", 0x21) +
                       struct.pack("<I", length) + bytes([mtype]) +
                       struct.pack("<H", 0) + bytes([decimals]) + b"\x00\x00")
            self.send(payload)
        self.send_eof()
        for row in cell_texts(result):
            nb = (len(row) + 7 + 2) // 8
            bitmap = bytearray(nb)
            body = b""
            for i, (v, (mtype, t)) in enumerate(zip(row, mtypes)):
                if v is None:
                    bit = i + 2  # binary-row null bitmap offset is 2
                    bitmap[bit // 8] |= 1 << (bit % 8)
                    continue
                if mtype == T_LONGLONG:
                    body += struct.pack("<q", int(v))
                elif mtype == T_DOUBLE:
                    body += struct.pack("<d", float(v))
                else:  # decimals, dates, strings ship as lenenc text
                    body += lenenc_str(v.encode())
            self.send(b"\x00" + bytes(bitmap) + body)
        self.send_eof()

    def _handle_query(self, sql: str):
        try:
            result = self.session.execute(sql)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self.send_err(1064, f"{type(e).__name__}: {e}")
            return
        if result.names:
            self.send_resultset(result)
        else:
            self.send_ok(affected=result.rowcount)


_US_PER_S = 1_000_000


def format_decimal(scaled: int, scale: int) -> str:
    """A DECIMAL's scaled int as MySQL's text: ``scale`` digits after
    the point, exactly (12345678901123456, 6 -> '12345678901.123456')."""
    if scale <= 0:
        return str(scaled)
    sign = "-" if scaled < 0 else ""
    whole, frac = divmod(abs(scaled), 10 ** scale)
    return f"{sign}{whole}.{frac:0{scale}d}"


def format_datetime(us: int) -> str:
    """Microseconds since the epoch as ``YYYY-MM-DD HH:MM:SS[.ffffff]``
    (the fraction only when it is not zero)."""
    secs, frac = divmod(int(us), _US_PER_S)
    days, rem = divmod(secs, 86400)
    h, rem = divmod(rem, 3600)
    m, sec = divmod(rem, 60)
    out = f"{days_to_date(days)} {h:02d}:{m:02d}:{sec:02d}"
    return out + f".{frac:06d}" if frac else out


def format_vector(row) -> str:
    """A VECTOR cell as OceanBase's text, ``[x,y,...]``: each float32 in
    the shortest form that reads back to the same float32 (the literal a
    client can send back)."""
    return "[" + ",".join(
        np.format_float_positional(x, unique=True, trim="-")
        for x in np.asarray(row, dtype=np.float32)) + "]"


def _column_texts(arr, t) -> list:
    """Every cell of one ``Result.arrays`` column as its wire text (NULLs
    are applied by the caller).  Whole columns convert at once: a large
    result must not hold the interpreter for a Python step per cell."""
    a = np.asarray(arr)
    kind = t.kind if t is not None else None
    if kind == TypeKind.DECIMAL:
        if a.dtype.kind in "iu":
            return [format_decimal(x, t.scale) for x in a.tolist()]
        return [f"{x:.{t.scale}f}" for x in a.tolist()]  # descaled doubles
    if kind == TypeKind.DATE:
        return (DATE_EPOCH + a.astype("timedelta64[D]")).astype(str).tolist()
    if kind == TypeKind.DATETIME:
        return [format_datetime(x) for x in a.tolist()]
    if kind == TypeKind.BOOL or a.dtype.kind == "b":
        return np.where(a.astype(bool), "1", "0").tolist()
    if kind == TypeKind.VECTOR:
        return [format_vector(x) for x in a.tolist()]
    # ints and doubles as Python prints them (``Result.rows()``'s values)
    return [str(x) for x in a.tolist()]


def _text_columns(result) -> list[list]:
    """Columns of wire cells from ``result.arrays``: the text of each
    cell, or None for NULL."""
    cols = []
    for name in result.names:
        texts = _column_texts(result.arrays[name], result.dtypes.get(name))
        valid = result.valids.get(name)
        if valid is not None:
            texts = [x if ok else None
                     for x, ok in zip(texts, np.asarray(valid).tolist())]
        cols.append(texts)
    return cols


def cell_texts(result) -> list[list]:
    """Rows of wire cells from ``result.arrays``: the text of each cell,
    or None for NULL."""
    return [list(r) for r in zip(*_text_columns(result))]


def _lenenc_cells(texts) -> list[bytes]:
    """A text-protocol column: each cell length-encoded, NULL as 0xfb."""
    out = []
    for v in texts:
        if v is None:
            out.append(b"\xfb")
            continue
        b = v.encode()
        out.append(bytes((len(b),)) + b if len(b) < 251 else lenenc_str(b))
    return out


def mysql_native_hash(password: str) -> bytes:
    """Stored credential: SHA1(SHA1(password)) — mysql_native_password."""
    return hashlib.sha1(
        hashlib.sha1(password.encode()).digest()).digest()


def _verify_native_password(users, user: str, token: bytes,
                            salt: bytes) -> bool:
    """Challenge verification: client sends
    SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw))); recover SHA1(pw) and check
    SHA1(SHA1(pw)) against the stored hash."""
    if users is None:
        # no user store wired (bare Session tests): root/empty only
        users = {"root": mysql_native_hash("")}
    stored = users.get(user)
    if stored is None:
        return False
    if stored == mysql_native_hash(""):
        return token == b""  # empty password: client sends no token
    if len(token) != 20:
        return False
    mask = hashlib.sha1(salt + stored).digest()
    sha_pw = bytes(a ^ b for a, b in zip(token, mask))
    return hashlib.sha1(sha_pw).digest() == stored


class MySQLServer:
    """Threaded TCP server handing each connection its own Session of
    the database's ``sys`` tenant, on the database's device (≙ the net
    frame delivering to tenant worker queues).  ``stop()`` also closes
    the live connections and waits for their threads, so no statement
    thread outlives the server."""

    def __init__(self, database, host="127.0.0.1", port=0):
        self.database = database
        self._live: dict = {}  # handler thread -> (socket, session)
        self._live_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # responses go out whole (_Conn.flush): no Nagle delay
                # on a response's last segment
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                me = threading.current_thread()
                session = outer.database.session()
                with outer._live_lock:
                    outer._live[me] = (self.request, session)
                try:
                    _Conn(self.request, session).serve()
                except OSError:
                    pass  # the client or stop() closed the socket
                finally:
                    session.close()
                    with outer._live_lock:
                        outer._live.pop(me, None)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="mysql-frontend")
        self._thread.start()
        return self

    def session(self, connection_id: int):
        """The Session serving the live connection whose greeting carried
        ``connection_id`` (None once it has gone)."""
        with self._live_lock:
            for _sock, sess in self._live.values():
                if sess.session_id == connection_id:
                    return sess
        return None

    def stop(self, timeout_s: float = 30.0):
        """Stop accepting, close every live connection, and wait (up to
        ``timeout_s``) for the connection threads: a statement that is
        running finishes first, then its thread sees the closed socket."""
        self._server.shutdown()
        self._server.server_close()
        with self._live_lock:
            live = list(self._live.items())
        for _th, (sock, _sess) in live:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for th, _conn in live:
            th.join(timeout_s)
