"""The port's wire: the codec, the reply digest and the rpc frame with
its fault plane, held against the reference's.

- ``encode_msg`` gives the same bytes in both packages, and each
  decodes the other's, on messages with int, float, bool, object (with
  NULL), bytes and multi-dimensional buffers and the escaped sentinel;
- ``arrays_crc`` is equal over numeric, string, object and validity
  columns;
- a port client talks to a reference server and back, on real sockets;
- the reference's ``tests/test_faults.py`` cases run again over the
  port's ``net/faults.py``, ``net/rpc.py`` and ``net/health.py``: the
  module is loaded with its imports pointed at the port, in process, on
  real sockets, and each of its tests is one case here.
Tolerance: exact.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from oceanbase_tpu.net import codec as jcodec
from oceanbase_tpu.storage.integrity import arrays_crc as jcrc
from oceanbase_tpu_torch.net import codec as tcodec
from oceanbase_tpu_torch.storage.integrity import arrays_crc as tcrc

HERE = os.path.dirname(os.path.abspath(__file__))


def _messages(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 50))
    strs = np.array([None if rng.random() < 0.2 else f"s{x}é"
                     for x in rng.integers(0, 99, n)], dtype=object)
    return [
        {"method": "das.scan", "params": {"table": "t", "offset": 0},
         "rid": 7, "src": 2},
        {"arrays": {"i": rng.integers(-10**15, 10**15, n),
                    "i32": rng.integers(0, 9, n).astype(np.int32),
                    "f": rng.normal(size=n),
                    "b": rng.random(n) < 0.5,
                    "s": strs,
                    "u": np.array([f"u{x}" for x in range(n)])},
         "valids": {"s": np.array([x is not None for x in strs])},
         "crc": int(rng.integers(0, 2**63)), "rows": n,
         "tm": [1, 2, 3, 4, 5], "types": {"i": ["int", 0, 0]}},
        {"payload": b"\x00\x01raw" * n, "vec": rng.normal(
            size=(n, 3)).astype(np.float32), "np_scalars": [
            np.int64(3), np.float64(2.5), np.bool_(True)],
         "nested": [{"__buf__": 1}, {"__esc__": "x", "k": [1, None]}],
         "none": None, "t": (1, 2)},
    ]


@pytest.mark.parametrize("seed", range(6))
def test_codec_bytes_match_reference_both_ways(seed):
    for msg in _messages(seed):
        jb, tb = jcodec.encode_msg(msg), tcodec.encode_msg(msg)
        assert tb == jb
        for enc, dec in ((jb, tcodec.decode_msg), (tb, jcodec.decode_msg)):
            got = dec(enc)
            # a decode re-encodes to the same bytes in either package
            assert tcodec.encode_msg(got) == jb
            assert jcodec.encode_msg(got) == jb


def test_codec_decodes_values():
    msg = _messages(3)[1]
    got = tcodec.decode_msg(tcodec.encode_msg(msg))
    for k, a in msg["arrays"].items():
        b = got["arrays"][k]
        if a.dtype.kind in "OU":
            assert list(b) == [None if x is None else str(x) for x in a]
        else:
            assert b.dtype == a.dtype and np.array_equal(a, b)
    assert got["crc"] == msg["crc"] and got["tm"] == msg["tm"]


@pytest.mark.parametrize("seed", range(4))
def test_arrays_crc_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n = 64
    arrays = {"k": rng.integers(0, 10**9, n),
              "f": rng.normal(size=n),
              "s": np.array([None if rng.random() < 0.3 else f"v{x}"
                             for x in range(n)], dtype=object),
              "u": np.array([f"w{x}" for x in range(n)]),
              "b": rng.random(n) < 0.5}
    valids = {"s": np.array([x is not None for x in arrays["s"]]),
              "k": rng.random(n) < 0.9}
    assert tcrc(arrays, valids) == jcrc(arrays, valids)
    assert tcrc(arrays) == jcrc(arrays)
    # insertion order does not matter; content does
    assert tcrc(dict(reversed(list(arrays.items()))), valids) == \
        tcrc(arrays, valids)
    arrays["k"] = arrays["k"].copy()
    arrays["k"][0] += 1
    assert tcrc(arrays, valids) == jcrc(arrays, valids)


def test_port_client_and_reference_server_interoperate():
    from oceanbase_tpu.net.rpc import RpcClient as JClient
    from oceanbase_tpu.net.rpc import RpcServer as JServer
    from oceanbase_tpu_torch.net.rpc import RpcClient as TClient
    from oceanbase_tpu_torch.net.rpc import RpcServer as TServer

    def scan(n=4):
        a = np.arange(n)
        return {"arrays": {"a": a}, "crc": tcrc({"a": a})}

    for Server, Client in ((JServer, TClient), (TServer, JClient)):
        srv = Server("127.0.0.1", 0, {"das.scan": scan,
                                      "ping": lambda: "pong"})
        srv.start()
        try:
            cli = Client("127.0.0.1", srv.port)
            assert cli.ping()
            r = cli.call("das.scan", n=9)
            assert np.array_equal(r["arrays"]["a"], np.arange(9))
            assert r["crc"] == jcrc({"a": np.arange(9)})
            cli.close()
        finally:
            srv.stop()


def test_policies_match_reference():
    from oceanbase_tpu.net.rpc import POLICIES as JP
    from oceanbase_tpu_torch.net.rpc import POLICIES as TP

    assert TP == {k: type(TP[k])(**vars(v)) for k, v in JP.items()}


# ---------------------------------------------------------------------------
# the reference's fault-plane suite over the port
# ---------------------------------------------------------------------------


def _port_copy(name: str):
    """``tests/<name>.py`` with every ``oceanbase_tpu.`` import pointed
    at ``oceanbase_tpu_torch.``, loaded as a module of its own."""
    with open(os.path.join(HERE, name + ".py")) as f:
        src = f.read().replace("oceanbase_tpu.", "oceanbase_tpu_torch.")
    spec = importlib.util.spec_from_loader(f"_port_{name}", loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src, f"<port copy of {name}.py>", "exec"), mod.__dict__)
    return mod


FAULTS = _port_copy("test_faults")
assert "oceanbase_tpu_torch.net.rpc" in FAULTS.RpcClient.__module__
CASES = sorted(n for n in dir(FAULTS) if n.startswith("test_"))


@pytest.mark.parametrize("case", CASES)
def test_reference_fault_suite_over_the_port(case):
    fn = getattr(FAULTS, case)
    import inspect

    params = inspect.signature(fn).parameters
    echo = FAULTS.EchoServer() if "echo" in params else None
    try:
        fn(**({"echo": echo} if echo is not None else {}))
    finally:
        if echo is not None:
            echo.stop()
