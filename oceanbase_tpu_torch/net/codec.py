"""Binary message codec: JSON control header + raw column buffers.

Reference analog: the obrpc serialization layer (OB_UNIS codegen,
deps/oblib/src/lib/utility/ob_unify_serialize.h) — here a message is a
Python dict whose numpy arrays are lifted out of the JSON body and sent
as length-prefixed binary sections, so snapshot scans ship column data
without base64/pickle overhead (pickle is also a non-starter across
trust boundaries).

Wire layout:
    u32 header_len | header json | u32 len0 | buf0 | u32 len1 | buf1 ...
header = {"body": <json with arrays replaced by {"__buf__": i}>,
          "bufs": [{"dtype": "<i8"} | {"dtype": "object", "len": n}
                   | {"dtype": "bytes"}]}
object/str arrays are encoded as UTF-8 with u32 length prefixes per
element (SQL strings), marked dtype "object".

Port of ``oceanbase_tpu/net/codec.py``, line for line: host code over
numpy, so a message encodes to the same bytes in both packages.  No
tensor ever reaches it: callers hand it host arrays.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_U32 = struct.Struct("<I")
_NONE = 0xFFFFFFFF


def _encode_obj_array(a: np.ndarray) -> bytes:
    parts = []
    for v in a.tolist():
        if v is None:
            parts.append(_U32.pack(_NONE))
        else:
            b = str(v).encode("utf-8")
            parts.append(_U32.pack(len(b)) + b)
    return b"".join(parts)


def _decode_obj_array(buf: bytes, n: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    off = 0
    for i in range(n):
        (ln,) = _U32.unpack_from(buf, off)
        off += 4
        if ln == _NONE:
            out[i] = None
        else:
            out[i] = buf[off:off + ln].decode("utf-8")
            off += ln
    return out


def encode_msg(body) -> bytes:
    bufs: list[bytes] = []
    metas: list[dict] = []

    def lift(v):
        if isinstance(v, np.ndarray):
            if v.dtype == object or v.dtype.kind in "US":
                arr = v if v.dtype == object else v.astype(object)
                metas.append({"dtype": "object", "len": len(arr)})
                bufs.append(_encode_obj_array(arr))
            else:
                c = np.ascontiguousarray(v)
                metas.append({"dtype": c.dtype.str,
                              "shape": list(c.shape)})
                bufs.append(c.tobytes())
            return {"__buf__": len(bufs) - 1}
        if isinstance(v, (bytes, bytearray)):
            metas.append({"dtype": "bytes"})
            bufs.append(bytes(v))
            return {"__buf__": len(bufs) - 1}
        if isinstance(v, dict):
            if "__buf__" in v or "__esc__" in v:
                # escape user dicts that collide with the buffer sentinel
                return {"__esc__": {k: lift(x) for k, x in v.items()}}
            return {k: lift(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [lift(x) for x in v]
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, np.bool_):
            return bool(v)
        return v

    header = json.dumps({"body": lift(body),
                         "bufs": metas}).encode("utf-8")
    out = [_U32.pack(len(header)), header]
    for b in bufs:
        out.append(_U32.pack(len(b)))
        out.append(b)
    return b"".join(out)


def decode_msg(data: bytes):
    (hlen,) = _U32.unpack_from(data, 0)
    header = json.loads(data[4:4 + hlen].decode("utf-8"))
    metas = header["bufs"]
    raw: list[bytes] = []
    off = 4 + hlen
    for _m in metas:
        (n,) = _U32.unpack_from(data, off)
        off += 4
        raw.append(data[off:off + n])
        off += n

    def sink(v):
        if isinstance(v, dict):
            if "__esc__" in v and len(v) == 1:
                return {k: sink(x) for k, x in v["__esc__"].items()}
            if "__buf__" in v and len(v) == 1:
                i = v["__buf__"]
                m = metas[i]
                if m["dtype"] == "bytes":
                    return raw[i]
                if m["dtype"] == "object":
                    return _decode_obj_array(raw[i], m["len"])
                a = np.frombuffer(raw[i], dtype=np.dtype(m["dtype"]))
                return a.reshape(m["shape"]).copy()
            return {k: sink(x) for k, x in v.items()}
        if isinstance(v, list):
            return [sink(x) for x in v]
        return v

    return sink(header["body"])
