"""PX exchange: repartition/broadcast between plan fragments over a mesh.

Port of ``oceanbase_tpu/px/exchange.py`` (≙ ObPxTransmitOp slice calc +
DTL send, src/sql/engine/px/exchange/ob_px_transmit_op.cpp:576, and
ObPxReceiveOp channel polling, ob_px_receive_op.h:83).

The reference runs the per-shard body inside ``shard_map`` and each
exchange is one XLA collective.  The port has one controller driving P
shards in lockstep: a sharded relation is a list of P per-shard
``Relation``s, a shard-local operator is applied to each shard in turn,
and a collective takes the list and returns a list:

    HASH / PKEY   -> bucket the rows by hash(keys) % P into a [P, cap]
                     send layout; receiver j gets the concatenation of
                     every sender's bucket j, in sender order
                     (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``)
    BROADCAST     -> the concatenation of every shard, in shard order
                     (``all_gather(tiled=True)``)
    datahub       -> the sum of the per-shard scalars, on the device
                     (``psum``)

A ``Mesh`` is an ordered list of P ``torch.device``s.  When two shards
sit on different cards a piece moves with ``.to(device,
non_blocking=True)``; when they share a card it does not move.  One code
path serves both: each sender scatters into its own [P, cap] send
buffer and each receiver concatenates its slices.  Capacities are static as in the reference: the planner budgets
``cap_per_dest`` and rows past it are counted into a diagnostics lane,
never silently dropped.  Nothing here reads a tensor on the host except
``shard_relation_by_hash``, which reads its bucket size (one scalar).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from oceanbase_tpu_torch import default_device
from oceanbase_tpu_torch.exec.ops import _combined_key, _mix64, _shr, merge_dicts
from oceanbase_tpu_torch.expr import ir
from oceanbase_tpu_torch.expr.compile import eval_expr
from oceanbase_tpu_torch.vector.column import Column, Relation, take

PX_AXIS = "px"


@dataclass(frozen=True)
class Mesh:
    """P shard devices in shard order, under one axis name."""

    devices: tuple
    axis: str = PX_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


# the process mesh size: None = the visible devices of the entry point's
# device type (the counterpart of the reference's
# --xla_force_host_platform_device_count)
_MESH_SIZE: int | None = None


def set_mesh_size(n: int | None) -> None:
    """Set the process mesh size to ``n`` shards (placed round-robin on
    the visible devices), or back to the device count with None."""
    global _MESH_SIZE
    if n is not None and int(n) < 1:
        raise ValueError(f"mesh size {n} < 1")
    _MESH_SIZE = None if n is None else int(n)


def _visible(dev_type: str) -> int:
    return torch.cuda.device_count() if dev_type == "cuda" else 1


def mesh_size(device=None) -> int:
    """Shards in the process mesh for ``device``'s type."""
    dev = default_device(device)
    return _MESH_SIZE if _MESH_SIZE is not None else _visible(dev.type)


def default_mesh(n: int | None = None, device=None) -> Mesh:
    """The first ``n`` shards of the process mesh (all of it with None):
    shard i on device ``i % count`` of ``device``'s type (``cuda``
    unless the caller asks for ``cpu``)."""
    dev = default_device(device)
    size = mesh_size(dev)
    if n is not None:
        size = min(int(n), size)
    if dev.type == "cuda":
        count = _visible("cuda")
        devs = tuple(torch.device("cuda", i % count) for i in range(size))
    else:
        devs = (dev,) * size
    return Mesh(devs)


def _to(x: torch.Tensor, dev) -> torch.Tensor:
    return x if x.device == dev else x.to(dev, non_blocking=True)


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 ``h % n`` of int64 lanes holding uint64 bits: split
    into 32-bit halves, each reduced mod n (n < 2^31)."""
    hi = _shr(h, 32)
    lo = h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


# ---------------------------------------------------------------------------
# sharding whole tables onto the mesh (granule assignment)
# ---------------------------------------------------------------------------


def _split(rel: Relation, mesh: Mesh, per: int) -> list[Relation]:
    """Cut a relation of P*per lanes (mask materialized) into P shards of
    ``per`` lanes on their devices."""
    out = []
    for i, dev in enumerate(mesh.devices):
        sl = slice(i * per, (i + 1) * per)
        cols = {n: Column(_to(c.data[sl], dev),
                          None if c.valid is None else _to(c.valid[sl], dev),
                          c.dtype, c.sdict)
                for n, c in rel.columns.items()}
        out.append(Relation(columns=cols, mask=_to(rel.mask[sl], dev)))
    return out


def shard_relation(rel: Relation, mesh: Mesh) -> list[Relation]:
    """Row-shard a device relation across the mesh (block distribution).

    ≙ granule->worker assignment (ObGranulePump::fetch_granule_task,
    src/sql/engine/px/ob_granule_pump.cpp:361) made static: contiguous
    row ranges per shard.  Pads capacity to a multiple of the mesh size
    with dead rows.  On one device the shards are views of the table."""
    ndev = mesh.size
    n = rel.capacity
    cap = ((n + ndev - 1) // ndev) * ndev
    return _split(rel.pad_to(cap), mesh, cap // ndev)


def shard_relation_by_hash(rel: Relation, key_cols: Sequence[str],
                           mesh: Mesh) -> list[Relation]:
    """Hash-shard a device relation by key columns: rows with equal keys
    land on the same shard, so a join between two relations sharded on
    their join keys needs NO exchange (partition-wise join / PKEY
    distribution, ≙ ob_pwj_comparer.h matching + PKEY slice routing).

    The reference buckets on the host with a numpy mirror of the device
    hash; the port buckets on the device with the device hash itself,
    and reads one scalar, the largest bucket, which sizes every shard.
    Key columns must be non-string (dict codes are relation-local);
    NULL-key rows hash on 0 — they never match an equi-join."""
    ndev = mesh.size
    n = rel.capacity
    datas = []
    for c in key_cols:
        col = rel.columns[c]
        d = col.data.to(torch.int64)
        if col.valid is not None:
            d = torch.where(col.valid, d, torch.zeros_like(d))
        datas.append(d)
    if len(datas) == 1:
        k = datas[0]
    else:
        k = torch.zeros(n, dtype=torch.int64, device=datas[0].device)
        for d in datas:
            k = _mix64(k ^ _mix64(d))
    mask = rel.mask_or_true()
    dest = torch.where(mask, _umod(_mix64(k), ndev),
                       torch.full_like(k, ndev))  # dead rows: no shard
    order = torch.sort(dest, stable=True).indices
    sd = take(dest, order)
    start = torch.searchsorted(
        sd, torch.arange(ndev + 1, dtype=torch.int64, device=sd.device))
    counts = start[1:] - start[:-1]
    # the one host read: the bucket size every shard is padded to
    cap = max(int(counts.max()), 1)  # obcheck: ok(trace.host-sync)
    cap = ((cap + 7) // 8) * 8  # mild alignment
    in_bucket = torch.arange(n, device=sd.device) - take(start, sd)
    live = sd < ndev
    slot = torch.where(live, sd * cap + in_bucket,
                       torch.full_like(sd, ndev * cap))
    cols = {}
    for name, c in rel.columns.items():
        v = None
        if c.valid is not None:
            v = _scatter(take(c.valid, order), slot, ndev * cap)
        cols[name] = Column(_scatter(take(c.data, order), slot, ndev * cap),
                            v, c.dtype, c.sdict)
    out_mask = _scatter(take(mask, order), slot, ndev * cap)
    return _split(Relation(columns=cols, mask=out_mask), mesh, cap)


def _scatter(x: torch.Tensor, slot: torch.Tensor, size: int) -> torch.Tensor:
    """Rows of ``x`` to their ``slot`` of a zero buffer of ``size`` rows;
    slot ``size`` is the drop slot (one extra row, cut off)."""
    buf = torch.zeros((size + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((slot,), x)
    return buf[:-1]


def unshard_relation(shards: Sequence[Relation], device=None) -> Relation:
    """Gather a sharded relation into one relation on ``device`` (the
    first shard's by default), shards in mesh order."""
    dev = shards[0].device if device is None else torch.device(device)
    cols = {}
    for name, c0 in shards[0].columns.items():
        cs = [r.columns[name] for r in shards]
        sdict = c0.sdict
        if any(c.sdict != sdict for c in cs):
            cs, sdict = merge_dicts(cs)
        valid = None
        if any(c.valid is not None for c in cs):
            valid = torch.cat([_to(c.valid_or_true(), dev) for c in cs])
        cols[name] = Column(torch.cat([_to(c.data, dev) for c in cs]),
                            valid, c0.dtype, sdict)
    mask = None
    if any(r.mask is not None for r in shards):
        mask = torch.cat([_to(r.mask_or_true(), dev) for r in shards])
    return Relation(columns=cols, mask=mask)


# ---------------------------------------------------------------------------
# collectives over the shards (the in-SPMD exchanges of the reference)
# ---------------------------------------------------------------------------


def _hash_dest(rel: Relation, keys: Sequence[ir.Expr], ndev: int):
    cols = [eval_expr(e, rel) for e in keys]
    k, _ = _combined_key(cols)
    return _umod(_mix64(k), ndev)


def _slots(dest: torch.Tensor, ndev: int, cap: int):
    """Per sender: (row order, rank within its destination bucket, live
    lane, overflow count).  Dead rows carry dest == ndev."""
    n = dest.shape[0]
    order = torch.sort(dest, stable=True).indices
    s_dest = take(dest, order)
    # bucket starts of the sorted dests (jnp.bincount's exclusive cumsum;
    # torch.bincount on a CUDA tensor reads its maximum on the host)
    start = torch.searchsorted(
        s_dest, torch.arange(ndev + 1, dtype=torch.int64,
                             device=dest.device))
    pos = torch.arange(n, device=dest.device) - take(start, s_dest)
    sent = s_dest < ndev
    live = sent & (pos < cap)
    overflow = (sent & (pos >= cap)).to(torch.int64).sum()
    return order, s_dest, pos, live, overflow


def exchange_by_dest(shards: Sequence[Relation], dests: Sequence,
                     mesh: Mesh, cap_per_dest: int):
    """Ship each row of each shard to the shard its ``dests`` lane names
    (dead rows must carry dest == P, the drop sentinel).  The generic
    transmit half of every slice strategy — HASH, RANGE, PKEY all reduce
    to a dest vector (≙ ObSliceIdxCalc::get_slice_indexes + DTL send, as
    one all_to_all).

    -> (received shards, each of P*cap_per_dest lanes: sender i's rows
    for shard j at lanes [i*cap, (i+1)*cap) of shard j; per-shard
    overflow counts, on the senders' devices)."""
    ndev, cap = mesh.size, cap_per_dest
    width = ndev * cap
    plans = [_slots(d.to(torch.int64), ndev, cap) for d in dests]
    overflow = [p[4] for p in plans]
    slots = [torch.where(live, s_dest * cap + pos,
                         torch.full_like(pos, width))
             for (_o, s_dest, pos, live, _v) in plans]

    def deliver(get):
        # each sender's [P, cap] send buffer; receiver j concatenates
        # slice j of every sender's, in sender order
        sent = [_scatter(take(get(r), p[0]), s, width)
                for r, p, s in zip(shards, plans, slots)]
        return [torch.cat([_to(sent[i][j * cap:(j + 1) * cap], dev)
                           for i in range(ndev)])
                for j, dev in enumerate(mesh.devices)]

    masks = deliver(lambda r: r.mask_or_true())
    out_cols = [dict() for _ in range(ndev)]
    for name, c in shards[0].columns.items():
        datas = deliver(lambda r: r.columns[name].data)
        valids = ([None] * ndev if c.valid is None else
                  deliver(lambda r: r.columns[name].valid_or_true()))
        for j in range(ndev):
            out_cols[j][name] = Column(datas[j], valids[j], c.dtype,
                                       c.sdict)
    return ([Relation(columns=out_cols[j], mask=masks[j])
             for j in range(ndev)], overflow)


def all_to_all_repartition(shards: Sequence[Relation],
                           keys: Sequence[ir.Expr], mesh: Mesh,
                           cap_per_dest: int):
    """HASH-repartition every shard across the mesh: rows with the same
    key hash land on the same shard (≙ ObSliceIdxCalc hash slice + DTL
    send/recv, as one all_to_all) -> (shards, per-shard overflow)."""
    ndev = mesh.size
    dests = []
    for r in shards:
        m = r.mask_or_true()
        h = _hash_dest(r, keys, ndev)
        dests.append(torch.where(m, h, torch.full_like(h, ndev)))
    return exchange_by_dest(shards, dests, mesh, cap_per_dest)


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """``all_gather(tiled=True)`` of one tensor per shard: every shard
    gets the concatenation in shard order."""
    return [torch.cat([_to(x, dev) for x in xs]) for dev in mesh.devices]


def broadcast_gather(shards: Sequence[Relation], mesh: Mesh) -> list:
    """BROADCAST distribution: every shard receives every shard's rows
    (≙ ObSliceIdxCalc BROADCAST + bc2host; one all_gather)."""
    ndev = mesh.size
    out_cols = [dict() for _ in range(ndev)]
    for name, c in shards[0].columns.items():
        datas = all_gather([r.columns[name].data for r in shards], mesh)
        valids = ([None] * ndev if c.valid is None else all_gather(
            [r.columns[name].valid for r in shards], mesh))
        for j in range(ndev):
            out_cols[j][name] = Column(datas[j], valids[j], c.dtype,
                                       c.sdict)
    masks = all_gather([r.mask_or_true() for r in shards], mesh)
    return [Relation(columns=out_cols[j], mask=masks[j])
            for j in range(ndev)]


def datahub_psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Coordinator-mediated aggregation (≙ PX datahub,
    src/sql/engine/px/datahub/components/) — the sum of the per-shard
    values, on the first shard's device."""
    dev = xs[0].device
    return torch.stack([_to(x, dev) for x in xs]).sum(0)


def replicate(x: torch.Tensor, mesh: Mesh) -> list:
    """One copy of ``x`` per shard (the psum result every shard holds)."""
    return [_to(x, dev) for dev in mesh.devices]


__all__ = [
    "Mesh", "PX_AXIS", "all_gather", "all_to_all_repartition",
    "broadcast_gather", "datahub_psum", "default_mesh", "exchange_by_dest",
    "mesh_size", "replicate", "set_mesh_size", "shard_relation",
    "shard_relation_by_hash", "unshard_relation",
]
