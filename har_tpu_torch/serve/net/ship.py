"""Journal shipping: the failover hand-off currency over the wire.

Until now "multi-host" failover had one shared-disk dependency left:
the controller restored a dead worker's partition by READING ITS
JOURNAL DIRECTORY off a filesystem both processes could see.  This
module removes it.  Each worker host runs a tiny SHIP AGENT (a
separate OS process — it survives the worker's SIGKILL the way a
host-level daemon survives a process crash) that serves that host's
journal directories as chunked reads, and the adopting side pulls the
dead worker's segments + newest snapshot over the fleet's RPC transport
into a private staging directory, verifies them, and only then lets
the recovery layer replay a single record.

The protocol, and why each piece exists:

  framing     every chunk rides the journal's own CRC record framing
              (the wire frame IS ``journal.encode_record``), so a chunk
              corrupted in transit dies at the frame decoder before it
              can touch the staged copy;

  chunk acks  the transfer is a PULL: each ``ship_chunk`` RPC names an
              explicit ``(file, offset, n)`` and its response is the
              per-chunk acknowledgement.  Retries ride the RPC layer's
              backoff + request-id dedup, and a re-shipped chunk is
              idempotent BY OFFSET — asking twice writes once;

  resume      the receiver appends a ``ship_chunk`` record to a durable
              ship log (``ship.log``, same record framing) only AFTER
              the chunk's bytes are fsynced into the ``.part`` file.
              A crash on either end resumes from the last durable
              chunk: the log's replay gives the verified offsets and
              any unrecorded ``.part`` tail (a torn receive) is
              truncated away;

  digests     every file carries its whole-file sha256 in the manifest,
              checked BEFORE the ``.part`` is renamed into place.  A
              mismatch — torn ship, bit rot, a lying peer — is refused
              loudly and the file re-ships from offset 0; it is never
              replayed.  ``journal.load_journal`` enforces the same
              rule structurally: a directory holding ``ship.log``
              without ``ship.done`` cannot be restored at all.

Chaos points (declared in ``serve/chaos.py``, SHIP_KILL_POINTS):
``mid_ship_send`` fires in the AGENT (the sending host dies mid-ship;
the restarted agent serves the resume), ``mid_ship_recv`` in the
receiving controller between chunks, ``post_ship_pre_drain`` after the
verified ship lands but before the restored engine drains.

Port of ``har_tpu/serve/net/ship.py`` (stdlib, copied): manifests,
ship-log records and the RPCs are the JAX package's byte for byte, so
either package's ``fetch_journal`` pulls from either package's agent.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import sys
import time
from typing import Callable

from har_tpu_torch.serve.journal import (
    SHIP_DONE,
    SHIP_LOG,
    _SEG_PREFIX,
    _SNAP_PREFIX,
    _list_indexed,
    encode_record,
    read_segment,
)
from har_tpu_torch.serve.net.rpc import (
    RpcClient,
    RpcConnectionRefused,
    RpcDeadlineExceeded,
    RpcServer,
)
from har_tpu_torch.serve.net.wire import FrameError
from har_tpu_torch.utils.durable import atomic_write, fsync_dir

# pull granularity: small enough that smoke-scale journals still span
# many chunks (the resume/kill matrix needs mid-transfer boundaries to
# land in), large enough that a real multi-MB journal is not RPC-bound
DEFAULT_CHUNK_BYTES = 256 << 10

# cluster.controller.RETIRED_MARKER, spelled locally: the agent process
# must stay engine-free (no FleetServer import, no model) — it
# only streams bytes
_RETIRED = "retired.json"

# manifest entries name files RELATIVE to the journal dir, at most one
# directory deep (``snap.3/state.json``), from a closed character set —
# anything else is a hostile or corrupt peer
_SAFE_SEGMENT = re.compile(r"^[A-Za-z0-9._-]+$")


class ShipError(RuntimeError):
    """Ship protocol violation or an unrecoverably corrupt transfer
    (digest still wrong after the re-ship budget)."""


class ShipUnavailable(ShipError):
    """The ship agent is unreachable (refused, reset, or past its
    deadline budget): the failover PARKS and retries at a later poll —
    survivors keep serving; nothing is lost, only delayed."""


class ShipFaults:
    """Deterministic receiving-side storage faults for the ship tests
    (counter-based like ``LinkFaults`` — a chaos run replays exactly):

      ``torn``    the ``at``-th chunk writes only half its bytes and
                  aborts the transfer (the crash-between-write-and-
                  record model) — resume must truncate the unrecorded
                  tail and re-request the same offset;
      ``garble``  the ``at``-th chunk has one byte flipped before the
                  write (silent corruption past the wire CRC) — the
                  whole-file digest must refuse the ship and re-ship.
    """

    def __init__(self, action: str, at: int = 1):
        if action not in ("torn", "garble"):
            raise ValueError(f"unknown ship fault action {action!r}")
        self.action = action
        self.at = int(at)
        self.chunks = 0

    def hit(self) -> str | None:
        self.chunks += 1
        return self.action if self.chunks == self.at else None


class ShipTorn(OSError):
    """Raised by the injected ``torn`` fault after its half-write: the
    stand-in for the receiving process dying mid-chunk."""


def _check_rel(rel: str) -> str:
    parts = rel.split("/")
    if (
        len(parts) > 2
        or any(p in (".", "..") for p in parts)
        or not all(_SAFE_SEGMENT.match(p) for p in parts)
    ):
        raise ShipError(f"unsafe ship path {rel!r}")
    return rel


def _durable_prefix_len(path: str) -> int:
    """Byte length of the decodable record prefix of a framed log —
    exactly what ``read_segment`` would consume; everything past it is
    a torn tail."""
    import zlib

    from har_tpu_torch.serve.journal import _HDR

    with open(path, "rb") as f:
        data = f.read()
    pos, n = 0, len(data)
    while pos + _HDR.size <= n:
        meta_len, payload_len, crc = _HDR.unpack_from(data, pos)
        end = pos + _HDR.size + meta_len + payload_len
        if end > n:
            break
        body = data[pos + _HDR.size : end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            break
        try:
            json.loads(body[:meta_len].decode())
        except ValueError:
            break
        pos = end
    return pos


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def journal_manifest(root: str) -> list[dict]:
    """The file set a restore needs, with sizes and whole-file sha256
    digests: the newest COMPLETE snapshot's files plus every segment at
    or after its rotation point — exactly what ``load_journal`` reads.
    Files are hashed AS THEY ARE: a SIGKILL's torn segment tail ships
    byte-exact and the replay discards it there, same as in place."""
    snaps = _list_indexed(root, _SNAP_PREFIX)
    if not snaps:
        raise ShipError(
            f"{root} holds no complete snapshot — not a recoverable "
            "journal directory"
        )
    snap_path, base = snaps[-1]
    rels = [
        f"{_SNAP_PREFIX}{base}/{name}"
        for name in sorted(os.listdir(snap_path))
    ]
    rels.extend(
        os.path.basename(path)
        for path, idx in _list_indexed(root, _SEG_PREFIX)
        if idx >= base
    )
    out = []
    for rel in rels:
        path = os.path.join(root, _check_rel(rel))
        out.append(
            {
                "f": rel,
                "size": int(os.path.getsize(path)),
                "sha256": _sha256(path),
            }
        )
    return out


# ------------------------------------------------------------ the agent


class ShipAgent:
    """One host's journal file server: a selectors RPC loop over the
    directories under ``root`` (one per worker hosted there).  It holds
    NO fleet state and opens the journals read-only — the one write it
    performs is ``ship_retire``, the adopting controller durably
    marking a consumed partition on its home host."""

    def __init__(
        self,
        root: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        chaos: Callable[[str], None] | None = None,
    ):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.chaos = chaos
        self.rpc = RpcServer(self._handlers(), host=host, port=port)
        self._shutdown = False

    def _chaos(self, point: str) -> None:
        if self.chaos is not None:
            self.chaos(point)

    def _dir(self, name) -> str:
        path = os.path.join(self.root, _check_rel(str(name)))
        if not os.path.isdir(path):
            raise ShipError(f"no journal directory {name!r} on this host")
        return path

    # ------------------------------------------------------- handlers

    def _handlers(self) -> dict:
        def ship_list(meta, payload):
            dirs = []
            for name in sorted(os.listdir(self.root)):
                path = os.path.join(self.root, name)
                if not os.path.isdir(path):
                    continue
                holds_journal = any(
                    n.startswith((_SEG_PREFIX, _SNAP_PREFIX))
                    for n in os.listdir(path)
                ) or os.path.exists(os.path.join(path, _RETIRED))
                if not holds_journal:
                    continue
                dirs.append(
                    {
                        "name": name,
                        "retired": os.path.exists(
                            os.path.join(path, _RETIRED)
                        ),
                    }
                )
            return {"dirs": dirs}, b""

        def ship_manifest(meta, payload):
            return {"files": journal_manifest(self._dir(meta["dir"]))}, b""

        def ship_chunk(meta, payload):
            self._chaos("mid_ship_send")
            d = self._dir(meta["dir"])
            rel = _check_rel(str(meta["f"]))
            path = os.path.join(d, rel)
            off = int(meta["off"])
            n = int(meta["n"])
            if off < 0 or n <= 0:
                raise ShipError(f"bad chunk request off={off} n={n}")
            with open(path, "rb") as fh:
                fh.seek(off)
                data = fh.read(n)
            size = os.path.getsize(path)
            return (
                {
                    "f": rel,
                    "off": off,
                    "n": len(data),
                    "eof": off + len(data) >= size,
                },
                data,
            )

        def ship_retire(meta, payload):
            d = self._dir(meta["dir"])
            atomic_write(os.path.join(d, _RETIRED), payload.decode())
            return {}, b""

        def shutdown(meta, payload):
            self._shutdown = True
            return {}, b""

        return {
            "ship_list": ship_list,
            "ship_manifest": ship_manifest,
            "ship_chunk": ship_chunk,
            "ship_retire": ship_retire,
            "shutdown": shutdown,
        }

    # ----------------------------------------------------------- loop

    def serve_forever(self, *, max_idle_s: float = 0.0) -> int:
        try:
            while not self._shutdown:
                self.rpc.step(0.05)
                if (
                    max_idle_s
                    and time.monotonic() - self.rpc.last_activity
                    > max_idle_s
                ):
                    return 2  # orphaned: nobody ships from a dead suite
            return 0
        finally:
            self.close()

    def close(self) -> None:
        self.rpc.close()


# ----------------------------------------------------------- the client


class ShipClient:
    """One pooled connection to one host's ship agent.  Transport
    errors collapse to ``ShipUnavailable`` — the caller's policy is
    always the same (park the failover, retry at a later poll), so the
    finer taxonomy stops here."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        deadline_s: float = 5.0,
        retries: int = 2,
        stats=None,
    ):
        self.host = host
        self.port = int(port)
        self._client = RpcClient(
            host, port, deadline_s=deadline_s, retries=retries,
            stats=stats,
        )

    def bind_stats(self, stats) -> None:
        """Point the transport counters at the owning controller's
        ``net_stats`` (rebinding on adoption/takeover, like
        ``NetWorker.bind_stats``)."""
        self._client.stats = stats

    def _call(self, method, meta=None, payload=b""):
        from har_tpu_torch.serve.net.rpc import RpcRemoteError

        try:
            return self._client.call(method, meta, payload)
        except (
            RpcConnectionRefused,
            RpcDeadlineExceeded,
            FrameError,
        ) as exc:
            raise ShipUnavailable(
                f"ship agent {self.host}:{self.port}: {exc}"
            ) from exc
        except RpcRemoteError as exc:
            # an agent-side refusal (unsafe path, no complete snapshot,
            # a bad request) is a SOURCE problem, not a link problem:
            # surface it as ShipError so the controller can quarantine
            # the partition instead of crash-looping on it
            raise ShipError(
                f"ship agent {self.host}:{self.port} refused "
                f"{method}: {exc}"
            ) from exc

    def list(self) -> list[dict]:
        meta, _ = self._call("ship_list")
        return list(meta.get("dirs") or [])

    def retired(self, src: str) -> bool:
        for entry in self.list():
            if entry.get("name") == src:
                return bool(entry.get("retired"))
        return False

    def manifest(self, src: str) -> list[dict]:
        meta, _ = self._call("ship_manifest", {"dir": src})
        return list(meta["files"])

    def chunk(self, src: str, f: str, off: int, n: int):
        return self._call(
            "ship_chunk", {"dir": src, "f": f, "off": int(off), "n": int(n)}
        )

    def retire(self, src: str, entry: dict) -> None:
        self._call(
            "ship_retire",
            {"dir": src},
            json.dumps(entry).encode(),
        )

    def shutdown(self) -> None:
        try:
            self._call("shutdown")
        except ShipUnavailable:
            pass

    def close(self) -> None:
        self._client.close()


# ------------------------------------------------- the durable ship log


class _ShipJournal:
    """Append-only receive log in the staging directory, the journal's
    own record framing: each record is fsynced before ``append``
    returns, so a record's presence IS its durability.  The torn tail a
    mid-append crash leaves is discarded by ``read_segment`` at replay
    — and TRUNCATED here at open, before any new append: the reader
    stops at the first torn record, so appending after an interior
    tear would make every later record unreachable and silently turn
    "resume from the last durable chunk" into "re-pull from scratch"
    on the next crash (the same rescue FleetJournal.flush performs for
    its segments)."""

    def __init__(self, dest: str):
        self.path = os.path.join(dest, SHIP_LOG)
        first = not os.path.exists(self.path)
        self._fh = open(self.path, "ab")
        if first:
            fsync_dir(dest)
        else:
            durable = _durable_prefix_len(self.path)
            if self._fh.tell() > durable:
                self._fh.truncate(durable)

    def append(self, meta: dict) -> None:
        self._fh.write(encode_record(meta))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


class _ShipProgress:
    """What the ship log's replay proves durable so far."""

    __slots__ = ("src", "manifest", "offsets", "done_files", "done")

    def __init__(self):
        self.src = None
        self.manifest = None
        self.offsets: dict[str, int] = {}
        self.done_files: set[str] = set()
        self.done = False


def replay_ship_log(dest: str) -> _ShipProgress:
    """Rebuild transfer progress from the durable ship log (resume
    path).  Unknown record types are skipped — forward compat, same
    stance as the fleet replay loop."""
    prog = _ShipProgress()
    path = os.path.join(dest, SHIP_LOG)
    if not os.path.exists(path):
        return prog
    records, _torn = read_segment(path)
    for meta, _payload in records:
        t = meta.get("t")
        if t == "ship_begin":
            prog.src = meta.get("src")
            prog.manifest = meta.get("files")
        elif t == "ship_chunk":
            # the chunk's bytes were fsynced into the .part before this
            # record existed: the durable offset advances to its end
            prog.offsets[meta["f"]] = int(meta["off"]) + int(meta["n"])
        elif t == "ship_void":
            # a digest refusal voided the file: re-ship from zero
            prog.offsets[meta["f"]] = 0
        elif t == "ship_file":
            prog.done_files.add(meta["f"])
        elif t == "ship_remanifest":
            # the SOURCE was alive and changed shape under a tail
            # (har_tpu_torch.serve.net.tail): a snapshot rotated the segment
            # set.  Adopt the new manifest and forget progress on the
            # files it dropped — offsets for surviving files stand,
            # which is what makes the tail resume without re-pulling a
            # durable byte.
            prog.manifest = meta.get("files")
            keep = {e["f"] for e in prog.manifest or []}
            prog.offsets = {
                f: o for f, o in prog.offsets.items() if f in keep
            }
            prog.done_files = {
                f for f in prog.done_files if f in keep
            }
        elif t == "ship_done":
            prog.done = True
    return prog


# ------------------------------------------------------- the transfer


def fetch_journal(
    client: ShipClient,
    src: str,
    dest: str,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    chaos: Callable[[str], None] | None = None,
    stats=None,
    faults: ShipFaults | None = None,
    reships: int = 2,
) -> dict:
    """Pull journal directory ``src`` from a host's ship agent into the
    private staging directory ``dest`` — resumable, chunk-acked,
    digest-verified (module docstring has the protocol argument).
    Returns ``{"bytes", "chunks", "resumes", "reshipped", "files"}``;
    ``stats`` (a FleetStats) additionally receives the shipped_bytes /
    ship_chunks / ship_resumes counters.  Raises ``ShipUnavailable``
    when the agent is unreachable (the caller parks and retries) and
    ``ShipError`` when the source is provably corrupt (digest still
    wrong after ``reships`` re-ships) — which is a refusal to restore,
    never a restore of bad bytes."""
    os.makedirs(dest, exist_ok=True)

    def _chaos(point: str) -> None:
        # the receiving side's kill-point site (mid_ship_recv): the
        # controller's chaos hook threads through here, so the harness
        # can die between chunks with durable progress on disk
        if chaos is not None:
            chaos(point)

    out = {"bytes": 0, "chunks": 0, "resumes": 0, "reshipped": 0,
           "files": 0}
    prog = replay_ship_log(dest)
    if prog.done:
        # every digest verified on a prior attempt; re-land the done
        # marker in case the crash fell between the ship_done record
        # and the marker write (otherwise the dir would stay refused
        # by the digest-before-replay guard forever)
        _write_done_marker(dest)
        return out
    manifest = client.manifest(src)
    if prog.manifest is not None and manifest != prog.manifest:
        # the SOURCE changed under the transfer (a dead worker's dir is
        # immutable, so this means the host was repaired/replaced — the
        # quarantine-lift path): the durable progress no longer
        # describes these bytes.  Void the whole staging dir and start
        # clean — resuming against a stale manifest would pull a
        # chimera of two sources that can never verify.
        shutil.rmtree(dest)
        os.makedirs(dest)
        prog = _ShipProgress()
    ship_journal = _ShipJournal(dest)
    try:
        if prog.manifest is None:
            ship_journal.append(
                {"t": "ship_begin", "src": src, "files": manifest}
            )
        else:
            # a prior attempt's durable progress: this fetch is a resume
            out["resumes"] = 1
            if stats is not None:
                stats.ship_resumes += 1
        for entry in manifest:
            name = _check_rel(entry["f"])
            if name in prog.done_files:
                continue
            final = os.path.join(dest, name)
            parent = os.path.dirname(final)
            if parent != dest:
                os.makedirs(parent, exist_ok=True)
            if (
                os.path.exists(final)
                and os.path.getsize(final) == int(entry["size"])
                and _sha256(final) == entry["sha256"]
            ):
                # crashed between the rename and its log record: the
                # verified file is already in place — re-log and move on
                ship_journal.append({"t": "ship_file", "f": name})
                continue
            _fetch_file(
                client, src, name, entry, dest, ship_journal,
                prog.offsets.get(name, 0), chunk_bytes, _chaos, stats,
                faults, reships, out,
            )
            out["files"] += 1
        ship_journal.append({"t": "ship_done"})
    finally:
        ship_journal.close()
    _write_done_marker(dest)
    return out


def _write_done_marker(dest: str) -> None:
    """The cheap done marker ``load_journal``'s digest-before-replay
    guard reads — written only once every file's digest verified."""
    with open(os.path.join(dest, SHIP_DONE), "wb") as fh:
        fh.flush()
        os.fsync(fh.fileno())
    fsync_dir(dest)


def _fetch_file(client, src, name, entry, dest, ship_journal, off,
                chunk_bytes, _chaos, stats, faults, reships, out):
    """One file's chunk loop + whole-file digest verdict, re-shipping
    from offset 0 on a refused digest up to ``reships`` times."""
    final = os.path.join(dest, name)
    size = int(entry["size"])
    attempts = 0
    while True:
        part = final + ".part"
        with open(part, "ab") as fh:
            if fh.tell() > off:
                # bytes past the last durable ship_chunk record: a torn
                # receive (crash between write and record) — discard,
                # exactly like the journal reader discards a torn tail
                fh.truncate(off)
            while off < size:
                _chaos("mid_ship_recv")
                meta, payload = client.chunk(src, name, off, chunk_bytes)
                if (
                    meta.get("f") != name
                    or int(meta.get("off", -1)) != off
                    or int(meta.get("n", -1)) != len(payload)
                ):
                    # a mis-sequenced response (reordered or duplicated
                    # frame surviving the rpc dedup) must never land at
                    # the wrong offset — refuse the response, keep the
                    # durable state, let the retry re-request.  This is
                    # a LINK-layer anomaly, not proof the source is
                    # corrupt, so it maps to the park-and-retry path
                    # (ShipUnavailable), never the quarantine
                    raise ShipUnavailable(
                        f"mis-sequenced ship chunk for {name!r}: asked "
                        f"off={off}, got {meta}"
                    )
                if not payload:
                    raise ShipError(
                        f"short read shipping {name!r} at off={off} — "
                        "the source file shrank under the manifest"
                    )
                action = faults.hit() if faults is not None else None
                if action == "garble":
                    payload = (
                        payload[:-1]
                        + bytes([payload[-1] ^ 0xFF])
                    )
                if action == "torn":
                    fh.write(payload[: max(1, len(payload) // 2)])
                    fh.flush()
                    os.fsync(fh.fileno())
                    raise ShipTorn(
                        f"injected torn receive at {name!r} off={off}"
                    )
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
                ship_journal.append(
                    {"t": "ship_chunk", "f": name, "off": off,
                     "n": len(payload)}
                )
                off += len(payload)
                out["bytes"] += len(payload)
                out["chunks"] += 1
                if stats is not None:
                    stats.shipped_bytes += len(payload)
                    stats.ship_chunks += 1
        if _sha256(part) == entry["sha256"]:
            os.replace(part, final)
            fsync_dir(os.path.dirname(final))
            ship_journal.append({"t": "ship_file", "f": name})
            return
        # REFUSED: a torn or bit-rotted ship never reaches the replay.
        # Void the durable progress and re-ship the whole file.
        attempts += 1
        out["reshipped"] += 1
        try:
            os.remove(part)
        except OSError:
            pass
        ship_journal.append({"t": "ship_void", "f": name})
        off = 0
        if attempts > reships:
            raise ShipError(
                f"shipped copy of {name!r} failed its whole-file digest "
                f"{attempts} time(s) — the source is corrupt; refusing "
                "to restore from it"
            )


# --------------------------------------------------------- entry point


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serve-agent",
        description=(
            "journal ship agent: serves one host's worker journal "
            "directories (chunked, digest-manifested) to an adopting "
            "controller over the fleet RPC transport; prints one JSON "
            "ready line {host, port, pid, root} and serves until "
            "shutdown or idle timeout"
        ),
    )
    ap.add_argument("--root", required=True,
                    help="host directory containing worker journal dirs")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the ready line reports it")
    ap.add_argument("--max-idle-s", type=float, default=120.0,
                    help="exit when no RPC arrives for this long "
                         "(orphan protection); 0 disables")
    ap.add_argument("--chaos-point", default=None,
                    help="TESTING: os._exit(137) at the Nth hit of this "
                         "ship stage boundary (mid_ship_send) — a REAL "
                         "sender-host death mid-transfer")
    ap.add_argument("--chaos-at", type=int, default=1)
    ap.add_argument("--follow", action="append", default=[],
                    metavar="WID=HOST:PORT",
                    help="tail-follow a live worker's journal from its "
                         "ship agent and keep a warm replica (repeat "
                         "per source); turns this agent into a standby "
                         "whose staged copies are themselves shippable")
    ap.add_argument("--cycle-s", type=float, default=0.5,
                    help="standby tail cadence (with --follow)")
    return ap


def _parse_follow(specs):
    follows = {}
    for spec in specs:
        try:
            wid, addr = spec.split("=", 1)
            host, port = addr.rsplit(":", 1)
            follows[wid] = (host, int(port))
        except ValueError:
            raise SystemExit(
                f"--follow wants WID=HOST:PORT, got {spec!r}"
            )
    return follows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.follow:
        # standby mode replays records through the fleet engine; the
        # import stays behind the flag so a plain agent remains
        # engine-free
        from har_tpu_torch.serve.replica import StandbyHost

        host = StandbyHost(
            args.root, _parse_follow(args.follow), host=args.host,
            port=args.port, cycle_s=args.cycle_s,
        )
        print(
            json.dumps(
                {
                    "host": host.agent.rpc.host,
                    "port": host.agent.rpc.port,
                    "pid": os.getpid(),
                    "root": host.agent.root,
                    "follows": sorted(_parse_follow(args.follow)),
                }
            ),
            flush=True,
        )
        return host.serve_forever(max_idle_s=args.max_idle_s)
    chaos = None
    if args.chaos_point:
        from har_tpu_torch.serve.net.worker import _HardKillPlan

        chaos = _HardKillPlan(args.chaos_point, args.chaos_at)
    agent = ShipAgent(args.root, host=args.host, port=args.port,
                      chaos=chaos)
    print(
        json.dumps(
            {
                "host": agent.rpc.host,
                "port": agent.rpc.port,
                "pid": os.getpid(),
                "root": agent.root,
            }
        ),
        flush=True,
    )
    return agent.serve_forever(max_idle_s=args.max_idle_s)


if __name__ == "__main__":  # pragma: no cover - subprocess entrypoint
    sys.exit(main())
