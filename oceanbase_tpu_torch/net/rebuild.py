"""Wiped-replica rebuild: bootstrap a node from a peer's checkpoint +
WAL, then let ordinary catch-up finish the job.

Reference analog: the replica rebuild / migration dag-nets
(src/storage/high_availability/ob_storage_ha_dag.h,
ob_ls_migration_handler) — a new or wiped replica copies a consistent
baseline (tablet metas + macro blocks ≙ manifest + segment files) from a
source replica, then replays the log tail.

Protocol (server side registered on every NodeServer):

    rebuild.fetch_meta()
        -> {"node_id", "wal_lsn", "role", "manifest": bytes,
            "slog": bytes, "files": [{"name", "size",
            "kind": "data" | "wal"}]}
        The peer checkpoints first and ships the manifest + slog BYTES
        inline (atomic with the file list — a checkpoint racing the
        chunked downloads cannot hand the client a NEWER manifest whose
        segments were never listed).  The listed segment files are
        immutable once written and never deleted; the WAL file is
        append-only — a chunk boundary racing an append at worst tears
        the final entry, which the torn-tail scan at boot truncates and
        catch-up re-ships.

    rebuild.fetch_segments(name, offset, limit)
        -> {"data": bytes, "eof": bool, "size": int, "crc": int}
        One chunk of one baseline file (byte-accounted, idempotent —
        the retry budget in net/rpc.py::POLICIES applies).  Every chunk
        carries a crc64 the client verifies BEFORE writing (a corrupt
        chunk re-fetches, bounded); listed data files additionally carry
        a whole-file crc in fetch_meta, re-verified after assembly —
        corrupt bytes are never installed.

Client side (``maybe_rebuild``) runs BEFORE the tenant boots: files
download into ``<root>/.rebuild_tmp`` and install in crash-safe order
(segments → slog → WAL → manifest last), so an interrupted rebuild
either restarts from scratch or boots from a WAL-only prefix that full
replay reconstructs.

Port of ``oceanbase_tpu/net/rebuild.py``, line for line (host code).
"""

from __future__ import annotations

import logging
import os
import shutil
import time

from oceanbase_tpu_torch.native import crc64
from oceanbase_tpu_torch.server import admission as qadmission
from oceanbase_tpu_torch.server import trace as qtrace
from oceanbase_tpu_torch.storage.integrity import CorruptionError

log = logging.getLogger(__name__)

#: per-chunk crc-mismatch refetch budget (on top of the rpc-level retry
#: policy — that one covers LOST frames, this one corrupted payloads)
CHUNK_CRC_RETRIES = 3

#: default chunk budget per rebuild.fetch_segments call (overridable via
#: the rebuild_chunk_bytes knob); well under the 1 GiB frame cap
DEFAULT_CHUNK_BYTES = 4 << 20

#: generic name the wire uses for the peer's replica WAL file — each
#: side maps it to its own replica id's path
WAL_NAME = "wal/replica.log"


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


class RebuildServer:
    """The peer half: serves its own root dir as a rebuild baseline."""

    def __init__(self, node):
        self.node = node
        # whole-file digest cache for fetch_meta's listing: baseline
        # data files are write-once under a given name, so (size,
        # mtime_ns) identity makes re-reading the whole dataset per
        # fetch_meta call unnecessary — repairs call fetch_meta per
        # table/attempt and must not pay O(dataset) each time
        self._crc_cache: dict[str, tuple[int, int, int]] = {}

    def handlers(self) -> dict:
        return {"rebuild.fetch_meta": self.fetch_meta,
                "rebuild.fetch_segments": self.fetch_segments}

    def _wal_path(self) -> str:
        return os.path.join(self.node.root, "wal",
                            f"replica_{self.node.node_id}.log")

    def _data_dir(self) -> str:
        return os.path.join(self.node.root, "data")

    def fetch_meta(self):
        """Checkpoint, then describe the baseline a wiped peer needs.
        Checkpointing first bounds the WAL tail the rebuilt node must
        replay; the manifest + slog ship INLINE so they are atomic with
        the segment list (a later checkpoint racing the chunked segment
        downloads must not hand the client a newer manifest referencing
        segments it never listed — boot would silently skip them)."""
        self.node.tenant.checkpoint()
        ddir = self._data_dir()

        def read(path):
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                return b""

        manifest = read(os.path.join(ddir, "manifest.json"))
        slog = read(os.path.join(ddir, "slog.jsonl"))
        files = []
        for base, _dirs, names in os.walk(ddir):
            for n in sorted(names):
                if n.endswith(".tmp") or ".corrupt" in n or \
                        n in ("manifest.json", "slog.jsonl"):
                    continue
                p = os.path.join(base, n)
                rel = os.path.join("data", os.path.relpath(p, ddir))
                # immutable data files carry a whole-file digest the
                # client re-verifies after chunked assembly (the WAL is
                # append-only — its digest would race appends; its
                # entry-level crc64s cover it at boot instead)
                files.append({"name": rel, "size": os.path.getsize(p),
                              "kind": "data", "crc": self._file_crc(p)})
        wal = self._wal_path()
        if os.path.exists(wal):
            files.append({"name": WAL_NAME,
                          "size": os.path.getsize(wal), "kind": "wal"})
        return {"node_id": self.node.node_id,
                "wal_lsn": self.node.engine.meta.get("wal_lsn", 0),
                "role": self.node.palf.replica.role,
                "manifest": manifest, "slog": slog,
                "manifest_crc": crc64(manifest), "slog_crc": crc64(slog),
                "files": files}

    def _file_crc(self, path: str) -> int:
        """crc64 of one baseline file, cached by (size, mtime_ns)
        identity — sound because data files are write-once under a
        given name (compaction/repair mint fresh ids)."""
        st = os.stat(path)
        hit = self._crc_cache.get(path)
        if hit is not None and hit[0] == st.st_size \
                and hit[1] == st.st_mtime_ns:
            return hit[2]
        with open(path, "rb") as f:
            crc = crc64(f.read())
        self._crc_cache[path] = (st.st_size, st.st_mtime_ns, crc)
        return crc

    def _resolve(self, name: str) -> str:
        """Map a wire file name to a real path, refusing traversal.
        Normalize BEFORE the prefix check: 'data/../config.json' would
        otherwise pass both a raw startswith('data/') test and the
        root containment test while escaping the data dir."""
        if name == WAL_NAME:
            return self._wal_path()
        norm = os.path.normpath(str(name))
        if os.path.isabs(norm) or \
                not norm.startswith("data" + os.sep) or \
                ".." in norm.split(os.sep):
            raise PermissionError(f"rebuild: refusing path {name!r}")
        root = os.path.abspath(self.node.root)
        p = os.path.abspath(os.path.join(root, norm))
        if not p.startswith(root + os.sep):
            raise PermissionError(f"rebuild: refusing path {name!r}")
        return p

    def fetch_segments(self, name: str, offset: int = 0,
                       limit: int = DEFAULT_CHUNK_BYTES):
        limit = max(1, min(int(limit), DEFAULT_CHUNK_BYTES * 4))
        p = self._resolve(str(name))
        size = os.path.getsize(p)
        with open(p, "rb") as f:
            f.seek(int(offset))
            data = f.read(limit)
        return {"data": data, "size": size, "crc": crc64(data),
                "eof": int(offset) + len(data) >= size}


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


def needs_rebuild(root: str, node_id: int) -> bool:
    """A node needs a rebuild when it has NO local recovery sources: no
    manifest, no slog, and no (non-trivial) replica WAL.  A partially
    wiped node (WAL kept) boots by full replay instead."""
    data = os.path.join(root, "data")
    if os.path.exists(os.path.join(data, "manifest.json")):
        return False
    slog = os.path.join(data, "slog.jsonl")
    if os.path.exists(slog) and os.path.getsize(slog) > 0:
        return False
    wal = os.path.join(root, "wal", f"replica_{node_id}.log")
    # magic-only file == empty log
    return not (os.path.exists(wal) and os.path.getsize(wal) > 8)


def _pick_source(peers: dict) -> tuple[int, object, dict] | None:
    """Probe peers; prefer the leader, else the longest committed log.
    Returns (peer_id, client, state) or None when no peer has data."""
    from oceanbase_tpu_torch.net.rpc import RpcError

    best = None
    for pid, cli in sorted(peers.items()):
        qadmission.checkpoint()  # KILL/deadline between peer probes
        try:
            st = cli.call("palf.state", _deadline_s=2.0)
        except (OSError, RpcError):
            # unreachable OR mid-boot/handler error: try the next peer
            continue
        committed = int(st.get("committed_lsn", 0))
        if committed <= 0:
            continue
        rank = (1 if st.get("role") == "leader" else 0, committed)
        if best is None or rank > best[0]:
            best = (rank, pid, cli, st)
    return None if best is None else best[1:]


def fetch_file(cli, name: str, dst: str,
               chunk_bytes: int = DEFAULT_CHUNK_BYTES,
               expect_crc: int | None = None) -> int:
    """Stream one baseline file over chunked ``rebuild.fetch_segments``
    with every chunk crc-verified before it is written (a corrupt chunk
    re-fetches, bounded by CHUNK_CRC_RETRIES) and an optional whole-file
    digest check after assembly.  -> bytes downloaded.  Shared by the
    wiped-node rebuild AND the scrub plane's segment repair."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    nbytes = 0
    with open(dst, "wb") as out:
        off = 0
        while True:
            qadmission.checkpoint()  # KILL/deadline between chunks
            r = None
            for attempt in range(CHUNK_CRC_RETRIES):
                r = cli.call("rebuild.fetch_segments", name=name,
                             offset=off, limit=int(chunk_bytes))
                if "crc" not in r or crc64(r["data"]) == r["crc"]:
                    break
                log.warning("rebuild: chunk crc mismatch %s@%d "
                            "(attempt %d)", name, off, attempt + 1)
            else:
                raise CorruptionError(
                    f"rebuild chunk crc mismatch after "
                    f"{CHUNK_CRC_RETRIES} attempts: {name}@{off}",
                    kind="rebuild", path=name)
            out.write(r["data"])
            off += len(r["data"])
            nbytes += len(r["data"])
            if r["eof"] or not r["data"]:
                break
    if expect_crc is not None:
        with open(dst, "rb") as f:
            got = crc64(f.read())
        if got != expect_crc:
            raise CorruptionError(
                f"rebuild file digest mismatch: {name}",
                kind="rebuild", path=name)
    return nbytes


def rebuild_from_peer(root: str, node_id: int, peers: dict,
                      recovery=None,
                      chunk_bytes: int = DEFAULT_CHUNK_BYTES):
    """Stream a peer's checkpoint + segments + WAL into ``root``.
    Returns a stats dict, or None when no peer has anything to offer
    (fresh-cluster boot)."""
    src = _pick_source(peers)
    if src is None:
        return None
    pid, cli, _st = src
    t0 = time.monotonic()
    with qtrace.span("rebuild.fetch", peer=pid) as sp:
        meta = cli.call("rebuild.fetch_meta")
        tmp = os.path.join(root, ".rebuild_tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        nbytes = 0
        for f in meta["files"]:
            qadmission.checkpoint()  # KILL/deadline between files
            dst = os.path.join(tmp, f["name"])
            nbytes += fetch_file(cli, f["name"], dst,
                                 chunk_bytes=int(chunk_bytes),
                                 expect_crc=f.get("crc"))
        # manifest + slog came inline with fetch_meta: the point-in-time
        # pair that matches the segment list we just streamed — each
        # verified against its fetch_meta digest before install
        os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
        for rel, blob, crc in (
                ("slog.jsonl", meta.get("slog", b""),
                 meta.get("slog_crc")),
                ("manifest.json", meta.get("manifest", b""),
                 meta.get("manifest_crc"))):
            if blob:
                if crc is not None and crc64(blob) != crc:
                    raise CorruptionError(
                        f"rebuild {rel} digest mismatch",
                        kind="rebuild", path=rel)
                with open(os.path.join(tmp, "data", rel), "wb") as out:
                    out.write(blob)
                nbytes += len(blob)
        _install(root, node_id, tmp, meta["files"])
        shutil.rmtree(tmp, ignore_errors=True)
        sp.tags.update(files=len(meta["files"]), bytes=nbytes)
    stats = {"peer": pid, "files": len(meta["files"]), "bytes": nbytes,
             "wal_lsn": int(meta.get("wal_lsn", 0)),
             "elapsed_s": time.monotonic() - t0}
    log.warning("node %d: rebuilt from peer %d — %d files, %d bytes, "
                "checkpoint replay point %d", node_id, pid,
                stats["files"], nbytes, stats["wal_lsn"])
    if recovery is not None:
        recovery.record("rebuild", peer=pid, nbytes=nbytes,
                        entries=len(meta["files"]),
                        wal_end_lsn=stats["wal_lsn"],
                        elapsed_s=stats["elapsed_s"],
                        note=f"files={stats['files']}")
    return stats


def _install(root: str, node_id: int, tmp: str, files: list[dict]):
    """Move the downloaded baseline into place, manifest LAST: an
    interrupted install leaves either nothing (rebuild restarts) or a
    WAL-only prefix (full replay reconstructs it)."""

    def move(rel_src: str, rel_dst: str):
        src = os.path.join(tmp, rel_src)
        if not os.path.exists(src):
            return
        dst = os.path.join(root, rel_dst)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(src, dst)

    manifest = os.path.join("data", "manifest.json")
    slog = os.path.join("data", "slog.jsonl")
    for f in files:
        if f["kind"] == "data" and f["name"] != manifest:
            move(f["name"], f["name"])
    move(slog, slog)
    move(WAL_NAME, os.path.join("wal", f"replica_{node_id}.log"))
    move(manifest, manifest)


def quarantine_corrupt_baseline(root: str, recovery=None):
    """Pre-boot integrity check of the local checkpoint baseline: a
    manifest or slog that fails its digest is quarantined (BOTH move
    aside — they are one point-in-time pair) so boot never trusts a
    rotten table/segment list.  The WAL stays: its entry-level crc64s
    self-verify at open, and full replay + leader catch-up reconstruct
    the state the quarantined checkpoint described."""
    from oceanbase_tpu_torch.storage.engine import (
        load_manifest,
        quarantine_file,
        read_slog,
    )

    data = os.path.join(root, "data")
    manifest = os.path.join(data, "manifest.json")
    slog = os.path.join(data, "slog.jsonl")
    bad = None
    try:
        if os.path.exists(manifest):
            load_manifest(manifest)
        if os.path.exists(slog) and os.path.getsize(slog):
            for _op in read_slog(slog):
                pass
    except CorruptionError as e:
        bad = e
    if bad is None:
        return False
    quarantined = []
    for p in (manifest, slog):
        if os.path.exists(p):
            quarantined.append(os.path.basename(quarantine_file(p)))
    log.warning("node baseline corrupt (%s): quarantined %s; booting "
                "by WAL replay / rebuild", bad, quarantined)
    if recovery is not None:
        recovery.record("quarantine", note=f"{bad.kind or 'baseline'} "
                        f"digest mismatch -> {','.join(quarantined)}")
    return True


def maybe_rebuild(root: str, node_id: int, peers: dict, recovery=None,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES):
    """The boot hook: rebuild iff this node is wiped AND a peer has
    data.  Runs BEFORE the engine/WAL open, so a rebuilt node boots
    through the ordinary restart path (checkpoint + WAL tail replay).
    A baseline failing its digests counts as wiped-of-baseline: the
    corrupt manifest/slog quarantine first, then either the rebuild
    path (no WAL) or full WAL replay reconstructs state."""
    from oceanbase_tpu_torch.net.rpc import RpcError

    if not root:
        return None
    quarantine_corrupt_baseline(root, recovery=recovery)
    if not needs_rebuild(root, node_id):
        return None
    try:
        return rebuild_from_peer(root, node_id, peers,
                                 recovery=recovery,
                                 chunk_bytes=chunk_bytes)
    except (OSError, RpcError, CorruptionError) as e:
        # a source dying mid-rebuild (or shipping bytes that fail their
        # digests past the retry budget) leaves only .rebuild_tmp
        # behind: boot continues empty and catch-up replays the log
        log.warning("node %d: rebuild aborted (%s); booting empty",
                    node_id, e)
        shutil.rmtree(os.path.join(root, ".rebuild_tmp"),
                      ignore_errors=True)
        return None
