"""The port's PX exchange (``oceanbase_tpu_torch/px/exchange.py``) against
the JAX package's inside ``shard_map`` on the same inputs, lane by lane:
block and hash sharding, the dest exchange, the HASH all_to_all, the
broadcast all_gather and the datahub psum, on meshes of 8 and 6 shards,
with poisoned dead lanes and an undersized per-destination budget.

The JAX side runs on the 8 host devices ``tests/conftest.py`` forces; the
port runs the same number of shards on the CPU (``set_mesh_size``), once
with every shard on one device (the exchange scatters into one buffer)
and once on a mesh whose devices differ (pieces move between them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import oceanbase_tpu.datatypes as jdt
import oceanbase_tpu.expr.ir as jir
import oceanbase_tpu.px.exchange as jx
import oceanbase_tpu_torch.expr.ir as tir
import oceanbase_tpu_torch.px.exchange as tx
from oceanbase_tpu.analysis.poison import poison_pad_lanes
from oceanbase_tpu.vector import column as jcol
from oceanbase_tpu_torch import bridge

torch.set_num_threads(2)

MESHES = [(8, "shared"), (6, "shared"), (8, "split"), (6, "split")]


@pytest.fixture(autouse=True)
def _mesh8():
    tx.set_mesh_size(8)
    yield
    tx.set_mesh_size(None)


def _tmesh(ndev, kind):
    if kind == "shared":
        return tx.default_mesh(ndev, "cpu")
    # two distinct device objects for one CPU: every exchange takes the
    # path that moves pieces between shard devices
    cpus = (torch.device("cpu"), torch.device("cpu", 0))
    return tx.Mesh(tuple(cpus[i % 2] for i in range(ndev)))


def jax_parts(rel):
    parts = {}
    for name, c in rel.columns.items():
        parts[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            (c.dtype.kind.value, c.dtype.precision, c.dtype.scale),
            None if c.sdict is None else c.sdict.values)
    return parts, None if rel.mask is None else np.asarray(rel.mask)


def _table(n=1003, seed=5, poison=True):
    """(JAX relation, port relation) on the same lanes; padded to the next
    bucket, a tenth of the live rows masked out, dead lanes poisoned."""
    rng = np.random.default_rng(seed)
    arrays = {
        "k": rng.integers(0, 40, n),
        "d": rng.integers(9000, 9030, n).astype(np.int32),
        "v": rng.integers(-10_000, 10_000, n),
        "x": rng.normal(size=n),
        "s": np.array(["a", "bb", "c", "dd"], dtype=object)[
            rng.integers(0, 4, n)],
        "b": rng.random(n) < 0.5,
    }
    types = {"v": jdt.SqlType.decimal(12, 2), "d": jdt.SqlType.date()}
    valids = {"k": rng.random(n) < 0.9, "x": rng.random(n) < 0.95}
    jrel = jcol.from_numpy(arrays, types=types, valids=valids)
    if poison:
        jrel = jrel.pad_to(jcol.bucket_capacity(n + 1))
        mask = np.asarray(jrel.mask) & (rng.random(jrel.capacity) < 0.9)
        jrel = poison_pad_lanes(jrel.with_mask(jnp.asarray(mask)))
    parts, mask = jax_parts(jrel)
    return jrel, bridge.relation_from_parts(parts, mask, device="cpu")


def assert_lanes_equal(jrel, trel):
    """Every lane of every column, validity and the mask, dead lanes
    included; dictionaries by value."""
    assert sorted(jrel.columns) == sorted(trel.columns)
    for name, jc in jrel.columns.items():
        tc = trel.columns[name]
        jd, td = np.asarray(jc.data), tc.data.numpy()
        assert jd.shape == td.shape, name
        assert np.array_equal(jd, td, equal_nan=jd.dtype.kind == "f"), name
        assert (jc.valid is None) == (tc.valid is None), name
        if jc.valid is not None:
            assert np.array_equal(np.asarray(jc.valid), tc.valid.numpy()), \
                name
        assert jc.dtype.kind.value == tc.dtype.kind.value, name
        if jc.sdict is not None:
            assert list(jc.sdict.values) == list(tc.sdict.values), name
    assert (jrel.mask is None) == (trel.mask is None)
    if jrel.mask is not None:
        assert np.array_equal(np.asarray(jrel.mask), trel.mask.numpy())


def _jrun(fn, jmesh, args, out_specs):
    run = jax.jit(jx.shard_map_compat(
        fn, mesh=jmesh, in_specs=tuple(P("px") for _ in args),
        out_specs=out_specs))
    return run(*args)


def _split_tensor(x: torch.Tensor, ndev: int) -> list:
    per = x.shape[0] // ndev
    return [x[i * per:(i + 1) * per] for i in range(ndev)]


@pytest.mark.parametrize("ndev,kind", MESHES)
def test_shard_relation_lanes(ndev, kind):
    jrel, trel = _table()
    jsh = jx.shard_relation(jrel, jx.default_mesh(ndev))
    tsh = tx.shard_relation(trel, _tmesh(ndev, kind))
    assert len(tsh) == ndev
    assert len({r.capacity for r in tsh}) == 1
    assert_lanes_equal(jx.unshard_relation(jsh), tx.unshard_relation(tsh))


@pytest.mark.parametrize("keys", [["k"], ["k", "d"], ["v"]])
@pytest.mark.parametrize("ndev", [8, 6])
def test_shard_relation_by_hash_lanes(ndev, keys):
    jrel, trel = _table(seed=7)
    jsh = jx.shard_relation_by_hash(jrel, keys, jx.default_mesh(ndev))
    tsh = tx.shard_relation_by_hash(trel, keys, tx.default_mesh(ndev, "cpu"))
    jun, tun = jx.unshard_relation(jsh), tx.unshard_relation(tsh)
    assert_lanes_equal(jun, tun)
    # each live row sits on the shard the reference's host hash names
    per = tsh[0].capacity
    mask = tun.mask.numpy()
    datas = []
    for c in keys:
        col = trel.columns[c]
        d = col.data.numpy().astype(np.int64)
        if col.valid is not None:
            d = np.where(col.valid.numpy(), d, 0)
        datas.append(d)
    if len(datas) == 1:
        k = datas[0]
    else:
        h = np.zeros(len(datas[0]), dtype=np.uint64)
        for d in datas:
            h = jx._np_mix64(h ^ jx._np_mix64(d.astype(np.uint64)))
        k = h.astype(np.int64)
    want = (jx._np_mix64(k.astype(np.uint64)) % np.uint64(ndev)).astype(
        np.int64)
    live = trel.mask.numpy()
    want_counts = np.bincount(want[live], minlength=ndev)
    got_counts = [int(mask[i * per:(i + 1) * per].sum())
                  for i in range(ndev)]
    assert got_counts == want_counts.tolist()


def _dest(mask: np.ndarray, ndev: int, seed: int):
    """Random destinations, the first half all to shard 0 (skewed); dead
    rows carry the drop sentinel."""
    d = np.random.default_rng(seed).integers(0, ndev, len(mask))
    d[: len(d) // 2] = 0
    return np.where(mask, d, ndev)


@pytest.mark.parametrize("ndev,kind", MESHES)
@pytest.mark.parametrize("cap", [400, 24])
def test_exchange_by_dest_lanes(ndev, kind, cap):
    """cap 24 is undersized (~1000/ndev^2 rows per bucket and a skewed
    half): overflow counts per shard must equal too."""
    jrel, trel = _table(seed=11)
    jmesh, tmesh = jx.default_mesh(ndev), _tmesh(ndev, kind)
    jsh = jx.shard_relation(jrel, jmesh)
    tsh = tx.shard_relation(trel, tmesh)
    mask = np.asarray(jsh.mask)
    dest = _dest(mask, ndev, 3)
    jdest = jax.device_put(dest.astype(np.int32),
                           NamedSharding(jmesh, P("px")))

    def fn(rel, d):
        out, ovf = jx.exchange_by_dest(rel, d, ndev, cap)
        return out, ovf[None]

    jout, jovf = _jrun(fn, jmesh, (jsh, jdest), (P("px"), P("px")))
    tdest = _split_tensor(torch.from_numpy(dest), ndev)
    tout, tovf = tx.exchange_by_dest(tsh, tdest, tmesh, cap)
    assert all(r.capacity == ndev * cap for r in tout)
    assert_lanes_equal(jx.unshard_relation(jout), tx.unshard_relation(tout))
    assert [int(v) for v in tovf] == np.asarray(jovf).tolist()
    if cap == 24:
        assert sum(int(v) for v in tovf) > 0


@pytest.mark.parametrize("ndev,kind", MESHES)
@pytest.mark.parametrize("keys,cap", [(["k"], 256), (["k", "s"], 256),
                                      (["x"], 256), (["k"], 16)])
def test_all_to_all_repartition_lanes(ndev, kind, keys, cap):
    jrel, trel = _table(seed=13)
    jmesh, tmesh = jx.default_mesh(ndev), _tmesh(ndev, kind)
    jsh = jx.shard_relation(jrel, jmesh)
    tsh = tx.shard_relation(trel, tmesh)

    def fn(rel):
        out, ovf = jx.all_to_all_repartition(
            rel, [jir.col(k) for k in keys], ndev, cap)
        return out, ovf[None]

    jout, jovf = _jrun(fn, jmesh, (jsh,), (P("px"), P("px")))
    tout, tovf = tx.all_to_all_repartition(
        tsh, [tir.col(k) for k in keys], tmesh, cap)
    assert_lanes_equal(jx.unshard_relation(jout), tx.unshard_relation(tout))
    assert [int(v) for v in tovf] == np.asarray(jovf).tolist()
    if cap == 16:
        assert sum(int(v) for v in tovf) > 0
    else:
        assert sum(int(v) for v in tovf) == 0
        # every live row arrived, and equal keys share a shard
        live = [int(r.mask.sum()) for r in tout]
        assert sum(live) == int(trel.mask.sum())


@pytest.mark.parametrize("ndev,kind", MESHES)
def test_broadcast_gather_and_psum(ndev, kind):
    jrel, trel = _table(n=301, seed=17)
    jmesh, tmesh = jx.default_mesh(ndev), _tmesh(ndev, kind)
    jsh = jx.shard_relation(jrel, jmesh)
    tsh = tx.shard_relation(trel, tmesh)

    def fn(rel):
        out = jx.broadcast_gather(rel)
        return out, jx.datahub_psum(rel.count())

    jout, jtotal = _jrun(fn, jmesh, (jsh,), (P("px"), P()))
    tout = tx.broadcast_gather(tsh, tmesh)
    assert len(tout) == ndev
    assert all(r.capacity == trel.capacity + (-trel.capacity) % ndev
               for r in tout)
    assert_lanes_equal(jx.unshard_relation(jout), tx.unshard_relation(tout))
    ttotal = tx.datahub_psum([r.count() for r in tsh])
    assert int(ttotal) == int(jtotal) == int(trel.mask.sum())
    assert ttotal.device == tsh[0].device


def test_mesh_defaults_and_refusals(monkeypatch):
    tx.set_mesh_size(None)
    assert tx.mesh_size("cpu") == 1
    assert tx.default_mesh(8, "cpu").size == 1  # capped at the mesh
    tx.set_mesh_size(8)
    m = tx.default_mesh(None, "cpu")
    assert m.size == 8 and set(m.devices) == {torch.device("cpu")}
    assert m.axis == "px"
    assert tx.default_mesh(3, "cpu").size == 3
    with pytest.raises(ValueError):
        tx.set_mesh_size(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tx.default_mesh(8)


def test_unsigned_modulo_matches_uint64():
    rng = np.random.default_rng(0)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     10_000, dtype=np.int64)
    for n in (1, 6, 7, 8, 1 << 17, 1_000_003):
        got = tx._umod(torch.from_numpy(x), n).numpy()
        want = (x.view(np.uint64) % np.uint64(n)).astype(np.int64)
        assert np.array_equal(got, want), n
