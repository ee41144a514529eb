"""``chunky-bits`` CLI: coreutils-like commands for files and clusters (the
port of ``chunky_bits_tpu/cli/main.py``).

Mirrors src/bin/chunky-bits/main.rs: global overrides ``--config``,
``--chunk-size``, ``--data-chunks``, ``--parity-chunks`` (:76-93), the
port's ``--backend``, and the subcommands (:96-177): cat, config-info,
cluster-info, cp, decode-shards, encode-shards, file-info,
find-unused-hashes, get-hashes, http-gateway, ls, migrate, resilver,
stats and verify, plus the storage-ops commands of the JAX package:
``scrub`` (one pass with ``--once``, else continuous) and
``meta-compact`` (cluster/meta_log.py maintenance and the
``--from-path-store`` migration into the indexed metadata plane).

Cluster locations are formatted ``cluster-name#path/to/file``; a location
for the cluster definition may be used instead of a name
(``./cluster.yaml#path``); ``@#location`` addresses a file reference;
``-`` is stdio.
"""

from __future__ import annotations

import argparse
import asyncio
import errno
import json
import os
import sys


from chunky_bits_tpu_torch.cli.cluster_location import ClusterLocation
from chunky_bits_tpu_torch.cli.config import Config
from chunky_bits_tpu_torch.errors import ChunkyBitsError, LocationError
from chunky_bits_tpu_torch.file import AnyHash, Location
from chunky_bits_tpu_torch.ops import get_coder
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils.yamlio import yaml_dump


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="chunky-bits",
        description="An interface for Chunky Bits files and clusters "
                    "(PyTorch/CUDA implementation).",
    )
    parser.add_argument("--config", help="Location for the config file")
    parser.add_argument("--chunk-size", type=int,
                        help="Default chunk size (log2) for non-cluster "
                             "destinations")
    parser.add_argument("--data-chunks", type=int,
                        help="Default data chunks for non-cluster "
                             "destinations")
    parser.add_argument("--parity-chunks", type=int,
                        help="Default parity chunks for non-cluster "
                             "destinations")
    parser.add_argument("--backend",
                        help="Erasure backend: cuda (the default), "
                             "cuda:<spec> (e.g. cuda:dp2,tp4), mesh, "
                             "native (the C++ host codec), native:<N> "
                             "(with N host threads), torch or numpy; the "
                             "JAX package's jax, jax:<spec> and auto "
                             "resolve to the card")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("cat", help="Concatenate files together")
    p.add_argument("targets", nargs="+")

    p = sub.add_parser("config-info",
                       help="Show the parsed configuration definition")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser("cluster-info",
                       help="Show the parsed cluster definition")
    p.add_argument("--json", action="store_true")
    p.add_argument("cluster")

    p = sub.add_parser("cp", help="Copy file from source to destination")
    p.add_argument("source")
    p.add_argument("destination")

    p = sub.add_parser("decode-shards",
                       help="Reassemble data from d-of-n shard files")
    p.add_argument("targets", nargs="+")

    p = sub.add_parser("encode-shards",
                       help="Split a source into d+p shard files")
    p.add_argument("source")
    p.add_argument("targets", nargs="+")

    p = sub.add_parser("file-info", help="Show a file reference")
    p.add_argument("--json", action="store_true")
    p.add_argument("source")

    p = sub.add_parser("find-unused-hashes",
                       help="Find all hashes that are not referenced")
    p.add_argument("--batch-size", type=int, default=100000)
    p.add_argument("-r", "--remove", action="store_true")
    p.add_argument("--grace-seconds", type=float, default=60.0,
                   help="skip chunk files younger than this (an in-flight"
                        " write stages chunks before publishing the"
                        " metadata that references them; 0 disables)")
    p.add_argument("source", nargs="+",
                   help="cluster/file-ref locations that define liveness")
    p.add_argument("hashes", nargs="*", default=[],
                   help="local hash directories to scan (after --)")

    p = sub.add_parser("get-hashes",
                       help="Get all the known hashes for a location")
    p.add_argument("-d", "--dedup", action="store_true",
                   dest="deduplicate")
    p.add_argument("-s", "--sort", action="store_true")
    p.add_argument("target")

    p = sub.add_parser("http-gateway",
                       help="Provide a HTTP Gateway for a cluster")
    p.add_argument("cluster")
    p.add_argument("-l", "--listen-addr", default="127.0.0.1:8000")
    p.add_argument("--max-put-size", type=int, default=None,
                   help="Reject PUT bodies larger than this many bytes")
    p.add_argument("--max-concurrent-puts", type=int, default=32,
                   help="Bound concurrent PUT ingests; 0 means unbounded "
                        "(default 32)")
    p.add_argument("--min-put-rate", type=int, default=256,
                   help="Abort PUTs averaging below this many bytes/sec "
                        "after a grace period; 0 disables (default 256)")
    p.add_argument("--max-concurrent-gets", type=int, default=256,
                   help="Shed GETs beyond this many in flight with "
                        "503 + Retry-After (per worker); 0 means "
                        "unbounded (default 256)")
    p.add_argument("--workers", type=int, default=None,
                   help="Serve with N pre-forked SO_REUSEPORT worker "
                        "processes (default: "
                        "$CHUNKY_BITS_TORCH_GATEWAY_WORKERS, else 1)")

    p = sub.add_parser("ls", help="List the files in a cluster directory")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("target")

    p = sub.add_parser(
        "meta-compact",
        help="Compact a cluster's meta-log metadata store (reclaim "
             "dead ref bytes, drop tombstones), optionally migrating "
             "a file-per-ref tree into the log first")
    p.add_argument("cluster")
    p.add_argument(
        "--from-path-store", metavar="DIR", default=None,
        help="before compacting, import every ref file under DIR "
             "(a 'type: path' metadata root) into the cluster's "
             "meta-log store, byte-for-byte; names already live in "
             "the log are skipped, so an interrupted migration simply "
             "re-runs")

    p = sub.add_parser(
        "migrate",
        help="Reference the file in its existing location and add parity")
    p.add_argument("source")
    p.add_argument("destination")

    p = sub.add_parser("resilver", help="Resilver a cluster file")
    p.add_argument("target")

    p = sub.add_parser(
        "scrub",
        help="Continuously verify cluster chunks against their golden "
             "digests and repair damaged parts")
    p.add_argument("cluster")
    p.add_argument("--once", action="store_true",
                   help="one full pass, print the report, exit "
                        "(default: run forever)")
    p.add_argument("--bytes-per-sec", type=float, default=None,
                   help="byte-rate bound for scrub reads (default: the "
                        "cluster's scrub_bytes_per_sec tunable / "
                        "$CHUNKY_BITS_TORCH_SCRUB_BYTES_PER_SEC; --once "
                        "runs unthrottled when neither is set)")
    p.add_argument("--interval", type=float, default=60.0,
                   help="idle seconds between passes (default 60)")
    p.add_argument("--no-repair", action="store_true",
                   help="detect and report only; never resilver")

    p = sub.add_parser(
        "stats",
        help="Fetch a running gateway's /stats, /healthz, /scrub/status,"
             " /alerts and /metrics and render a one-screen summary")
    p.add_argument("--json", action="store_true",
                   help="emit the combined raw JSON payloads instead")
    p.add_argument("--watch", type=float, default=0.0, metavar="N",
                   help="redraw every N seconds until ctrl-c (0 = one "
                        "shot, the default)")
    p.add_argument("url", help="gateway base URL (host:port or http://…)")

    p = sub.add_parser("verify", help="Verify a cluster file")
    p.add_argument("target")

    return parser


def _dump(obj, as_json: bool) -> None:
    if as_json:
        json.dump(obj, sys.stdout, indent=2)
        print()
    else:
        yaml_dump(obj, sys.stdout, sort_keys=False)


def _shard_geometry(args, targets: list) -> tuple[int, int]:
    """Infer (d, p) for the standalone shard codec (main.rs:521-559)."""
    if args.parity_chunks is None:
        raise ChunkyBitsError(
            "Parity Chunk Count must be known to decode shards")
    p = args.parity_chunks
    if args.data_chunks is not None:
        d = args.data_chunks
        if len(targets) != d + p:
            raise ChunkyBitsError(
                f"Invalid targets: Expected {d + p} targets but got "
                f"{len(targets)}")
        return d, p
    if len(targets) <= p:
        raise ChunkyBitsError(
            f"Invalid targets: Expected more than {p} targets but got "
            f"{len(targets)}")
    return len(targets) - p, p


async def run(args) -> int:
    if args.backend:
        # the flag reaches ops/backend's default resolution through the
        # environment, as in the JAX package
        from chunky_bits_tpu_torch.cluster.tunables import \
            set_default_backend
        from chunky_bits_tpu_torch.ops.backend import \
            canonical_backend_name

        canonical_backend_name(args.backend)  # a bad name fails here
        set_default_backend(args.backend)
    config = await Config.load_or_default(
        args.config, chunk_size=args.chunk_size,
        data_chunks=args.data_chunks, parity_chunks=args.parity_chunks)
    try:
        return await _run_command(args, config)
    finally:
        # close the loop-bound aiohttp sessions while the loop is alive,
        # or aiohttp warns "Unclosed client session" at interpreter exit
        from chunky_bits_tpu_torch.file.location import default_context

        await config.aclose()
        await default_context().aclose()


async def _run_command(args, config) -> int:
    cmd = args.command
    if cmd == "cat":
        destination = ClusterLocation.parse("-")
        for target in args.targets:
            await _copy(config, ClusterLocation.parse(target), destination)
    elif cmd == "config-info":
        _dump(config.to_obj(), args.json)
    elif cmd == "cluster-info":
        cluster = await config.get_cluster(args.cluster)
        _dump(cluster.to_obj(), args.json)
    elif cmd == "cp":
        await _copy(config, ClusterLocation.parse(args.source),
                    ClusterLocation.parse(args.destination))
    elif cmd == "decode-shards":
        targets = [ClusterLocation.parse(t) for t in args.targets]
        d, p = _shard_geometry(args, targets)
        coder = get_coder(d, p)
        shards = []
        for target in targets:
            try:
                reader = await target.get_reader(config)
                shards.append(await _read_all(reader))
            except (ChunkyBitsError, OSError) as err:
                print(f"Error {target}: {err}", file=sys.stderr)
                shards.append(None)
        import numpy as np

        arrays = [np.frombuffer(s, dtype=np.uint8) if s is not None
                  else None for s in shards]
        arrays = coder.reconstruct_data(arrays)
        out = sys.stdout.buffer
        for arr in arrays[:d]:
            if arr is not None:
                out.write(bytes(arr))
        out.flush()
    elif cmd == "encode-shards":
        targets = [ClusterLocation.parse(t) for t in args.targets]
        d, p = _shard_geometry(args, targets)
        coder = get_coder(d, p)
        source = ClusterLocation.parse(args.source)
        data_buf = await _read_all(await source.get_reader(config))
        from chunky_bits_tpu_torch.file.file_part import split_into_shards

        shards, _len = split_into_shards(data_buf, len(data_buf), d)
        import numpy as np

        parity = coder.encode([np.frombuffer(s, dtype=np.uint8)
                               for s in shards]) if p else []
        payloads = [bytes(s) for s in shards] + [bytes(x) for x in parity]
        for target, payload in zip(targets, payloads):
            try:
                await target.write_from_reader(
                    config, aio.BytesReader(payload))
            except (ChunkyBitsError, OSError) as err:
                print(f"Error {target}: {err}", file=sys.stderr)
    elif cmd == "file-info":
        source = ClusterLocation.parse(args.source)
        file_ref = await source.get_file_reference(
            config,
            await config.get_default_data_chunks(),
            await config.get_default_parity_chunks(),
            await config.get_default_chunk_size())
        _dump(file_ref.to_obj(), args.json)
    elif cmd == "find-unused-hashes":
        await find_unused_hashes(config, args)
    elif cmd == "get-hashes":
        target = ClusterLocation.parse(args.target)
        hashes = []
        async for h in target.get_hashes_rec(config):
            if args.sort or args.deduplicate:
                hashes.append(h)
            else:
                print(h)
        if args.sort:
            for h in sorted(set(hashes), key=str):
                print(h)
        elif args.deduplicate:
            for h in dict.fromkeys(hashes):
                print(h)
    elif cmd == "ls":
        target = ClusterLocation.parse(args.target)
        if args.recursive:
            async for entry in target.list_files_recursive(config):
                print(entry)
        else:
            for entry in await target.list_files(config):
                print(entry)
    elif cmd == "meta-compact":
        await meta_compact(config, args)
    elif cmd == "migrate":
        source = ClusterLocation.parse(args.source)
        destination = ClusterLocation.parse(args.destination)
        await source.migrate(config, destination)
    elif cmd == "resilver":
        target = ClusterLocation.parse(args.target)
        report = await target.resilver(config)
        print(report.display_full_report())
    elif cmd == "scrub":
        from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon

        cluster = await config.get_cluster(args.cluster)
        if not args.no_repair:
            # repairs run on the cluster's erasure backend: resolve it
            # before the pass, so a device backend without its card
            # fails here, before anything is read or written (the
            # daemon itself counts a failed repair and goes on)
            from chunky_bits_tpu_torch.ops.backend import get_backend

            get_backend(cluster.tunables.backend)
        daemon = ScrubDaemon(
            cluster, bytes_per_sec=args.bytes_per_sec,
            interval_seconds=args.interval, repair=not args.no_repair)
        if args.once:
            stats = await daemon.run_once()
            print(stats)
        else:
            # run until ctrl-c; print one stats line per pass so an
            # operator tailing the log sees progress
            try:
                while True:
                    stats = await daemon.run_once()
                    print(stats, flush=True)
                    await asyncio.sleep(max(args.interval, 0.0))
            # top-level ctrl-c handler of the
            # scrub command: asyncio.run is tearing this coroutine down
            # right after — nothing awaits it as a child task
            # lint: cancel-safety-ok top-level ctrl-c handler of the
            # scrub command: asyncio.run is tearing this coroutine down
            # right after — nothing awaits it as a child task
            except (KeyboardInterrupt, asyncio.CancelledError):
                pass
    elif cmd == "http-gateway":
        from chunky_bits_tpu_torch.gateway import serve

        cluster = await config.get_cluster(args.cluster)
        host, sep, port = args.listen_addr.rpartition(":")
        if not sep or not port.isdigit():
            raise ChunkyBitsError(
                f"invalid --listen-addr {args.listen_addr!r} "
                "(expected host:port)")
        await serve(cluster, host or "127.0.0.1", int(port),
                    max_put_bytes=args.max_put_size,
                    max_concurrent_puts=args.max_concurrent_puts,
                    min_put_rate=args.min_put_rate,
                    max_concurrent_gets=args.max_concurrent_gets,
                    workers=args.workers)
    elif cmd == "stats":
        from chunky_bits_tpu_torch.cli.stats import stats_command

        return await stats_command(args.url, args.json,
                                   watch_s=max(args.watch, 0.0))
    elif cmd == "verify":
        target = ClusterLocation.parse(args.target)
        report = await target.verify(config)
        print(report.display_full_report())
    return 0


async def _copy(config, source: ClusterLocation,
                destination: ClusterLocation) -> None:
    """Stream ``source`` into ``destination``; the reader is closed after,
    so a local source's file is released at once."""
    reader = await source.get_reader(config)
    try:
        await destination.write_from_reader(config, reader)
    finally:
        await aio.close_reader(reader)


async def _read_all(reader: aio.AsyncByteReader) -> bytes:
    """Drain and close ``reader``."""
    chunks = []
    try:
        while True:
            data = await reader.read(1 << 20)
            if not data:
                break
            chunks.append(data)
    finally:
        await aio.close_reader(reader)
    return b"".join(chunks)


async def meta_compact(config, args) -> None:
    """``meta-compact``: maintenance for the indexed metadata plane
    (cluster/meta_log.py).  Compacts the cluster's meta-log store —
    live refs copied into fresh log files, dead bytes reclaimed,
    tombstones dropped, the journal swapped atomically — and, with
    ``--from-path-store DIR``, first imports a file-per-ref metadata
    tree into the log: every ref's bytes are appended EXACTLY as the
    file holds them (byte identity across stores is the golden-pinned
    contract), with the index projection extracted from the parsed
    payload so the scrub/GC fast paths work for migrated refs too.
    The import is idempotent — names already live in the log are
    skipped — so an interrupted migration simply re-runs; unparseable
    files are surfaced on stderr and skipped like every walk in this
    CLI treats foreign entries."""
    from chunky_bits_tpu_torch.cluster.meta_log import (
        MetadataLog,
        extract_index_meta,
        norm_name,
    )
    from chunky_bits_tpu_torch.file.location import is_publish_temp

    cluster = await config.get_cluster(args.cluster)
    metadata = cluster.metadata
    if not isinstance(metadata, MetadataLog):
        raise ChunkyBitsError(
            f"cluster {args.cluster!r} metadata is not a meta-log "
            "store (set `metadata: {type: meta-log, ...}` in the "
            "cluster config first)")
    if args.from_path_store:
        root = args.from_path_store
        loads = metadata.format.loader()

        def _walk() -> list[tuple[str, str]]:
            out = []
            for dirpath, _dirs, files in os.walk(root):
                for fname in files:
                    if is_publish_temp(fname):
                        continue  # a crashed path-store writer's temp
                    full = os.path.join(dirpath, fname)
                    out.append(
                        (norm_name(os.path.relpath(full, root)), full))
            out.sort()
            return out

        def _import_one(name: str, full: str) -> bool:
            if metadata.store.lookup(name) is not None:
                return False  # already migrated: idempotent re-run
            with open(full, "rb") as f:
                data = f.read()
            try:
                payload = loads(data)
            except Exception as err:  # noqa: BLE001 — a foreign file
                # in the tree must not abort the migration
                print(f"Skipping unparseable {full}: {err}",
                      file=sys.stderr)
                return False
            hashes, nodes = extract_index_meta(payload)
            metadata.store.append(name, data,
                                  hashes=hashes, nodes=nodes)
            return True

        migrated = 0
        for name, full in await asyncio.to_thread(_walk):
            if await asyncio.to_thread(_import_one, name, full):
                migrated += 1
        print(f"Migrated {migrated} refs from {root}", file=sys.stderr)
    report = await metadata.compact()
    print(json.dumps(report))


async def find_unused_hashes(config, args) -> None:
    """GC: list hash files under local dirs, subtract hashes referenced by
    the sources, print/remove the orphans; batched (main.rs:329-435).

    Safe against concurrent ingest where the reference is not: a ``cp``
    stages chunk files BEFORE publishing the metadata that references
    them, so a racing GC would list the new chunk, find no reference,
    and delete it out from under the imminent publish.  Chunk files
    younger than ``--grace-seconds`` (measured against GC start) are
    therefore never candidates; the reference runs the same scan with no
    such guard (main.rs:329-435).

    Packed destinations (``slab:/dir``, file/slab.py) take the index
    fast path: candidates come from one scan of the store's index (no
    dirent walk), the publish time in each journal line stands in for
    the file mtime, and removal marks the extent dead for compaction
    instead of unlinking anything."""
    import time as _time

    from chunky_bits_tpu_torch.file import slab as slab_mod

    sources = [ClusterLocation.parse(s) for s in args.source]
    for s in sources:
        if s.kind not in ("cluster", "file_ref"):
            raise ChunkyBitsError(f"Unsupported source location: {s}")
    hash_dirs = [ClusterLocation.parse(h) for h in args.hashes]
    for h in hash_dirs:
        if h.kind != "other" or not (h.location.is_local()
                                     or h.location.is_slab()):
            raise ChunkyBitsError(f"Unsupported hashes location: {h}")
    cutoff = _time.time() - args.grace_seconds

    async def _age_of(path: str) -> str:
        """``"old"`` (a GC candidate), ``"fresh"`` (inside the grace
        window — an in-flight write may be about to reference it), or
        ``"gone"`` (vanished mid-scan).  stat runs off-loop like the
        listing's own metadata calls; slab candidates consult the
        extent's journal-recorded publish time instead of a stat."""
        if path.startswith("slab:"):
            root, name = os.path.split(Location.parse(path).target)
            ext = await asyncio.to_thread(
                slab_mod.get_store(root).lookup, name)
            if ext is None:
                return "gone"
            if args.grace_seconds <= 0:
                return "old"
            return "old" if ext.published < cutoff else "fresh"
        if args.grace_seconds <= 0:
            return "old"
        try:
            st = await asyncio.to_thread(os.stat, path)
        except OSError:
            return "gone"
        return "old" if st.st_mtime < cutoff else "fresh"

    # Atomic local publication stages temp files and renames in
    # (location.is_publish_temp defines the format next to its
    # producer); a writer killed hard leaves the temp behind with no
    # other reclamation path.  A temp is invisible until renamed, so
    # any one older than the grace window is dead — remove it here
    # (the scan ignores other unknown names, as the reference does,
    # main.rs:372-377).
    from chunky_bits_tpu_torch.file.location import is_publish_temp

    async def _reap_stale_temp(path: str) -> bool:
        if not is_publish_temp(os.path.basename(path)):
            return False
        if args.grace_seconds > 0 and await _age_of(path) != "old":
            return True  # a live writer's temp: skip, don't report
        print(f"Stale publish temp: {path}", file=sys.stderr)
        if args.remove:
            try:
                await Location.local(path).delete()
            except LocationError as err:
                # only the missing-file race is benign (renamed or
                # reaped concurrently); EACCES/EROFS etc. must surface
                # like the ordinary chunk path's failures do
                cause = err.__cause__
                if not (isinstance(cause, OSError)
                        and cause.errno == errno.ENOENT):
                    raise
        return True

    async def hash_files():
        for hash_dir in hash_dirs:
            if hash_dir.location.is_slab():
                # one scan of the packed store's index; the grace check
                # filters on the extents in hand (each journal line
                # carries its publish time), and _age_of re-checks just
                # before a delete
                root = hash_dir.location.target.rstrip("/")
                extents = await asyncio.to_thread(
                    slab_mod.get_store(root).live_extents)
                for name, ext in extents:
                    if args.grace_seconds > 0 \
                            and ext.published >= cutoff:
                        continue
                    yield f"slab:{os.path.join(root, name)}"
                continue
            async for entry in hash_dir.list_files_recursive(config):
                if not entry.is_file():
                    continue
                if await _reap_stale_temp(entry.path):
                    continue
                if await _age_of(entry.path) == "old":
                    yield entry.path

    files_iter = hash_files()
    done = False
    while not done:
        existing: dict[str, list[str]] = {}
        while len(existing) < args.batch_size:
            try:
                path = await files_iter.__anext__()
            except StopAsyncIteration:
                done = True
                break
            name = os.path.basename(path)
            try:
                hash_ = AnyHash.parse(name)
            except ChunkyBitsError:
                print(f"Unknown hash: {name}", file=sys.stderr)
                continue
            existing.setdefault(str(hash_), []).append(path)
        if not existing:
            break
        for source in sources:
            async for hash_ in source.get_hashes_rec(config):
                existing.pop(str(hash_), None)
        for hash_str, paths in existing.items():
            if not args.remove:
                print(hash_str)
                continue
            removed = False
            for path in paths:
                # Re-check age at the last moment: a concurrent ingest
                # can re-write a listed orphan (same content hash =>
                # same path) between the batch scan and this delete; a
                # fresh mtime means someone wants it again.
                age = await _age_of(path)
                if age == "gone":
                    continue  # someone else removed it — goal achieved
                if age == "fresh":
                    print(f"Skipping recently re-written {path}",
                          file=sys.stderr)
                    continue
                print(f"Removing {path}", file=sys.stderr)
                # a slab path marks the extent dead for compaction
                # (Location.delete's slab branch); plain paths unlink
                loc = (Location.parse(path) if path.startswith("slab:")
                       else Location.local(path))
                await loc.delete()
                removed = True
            if removed:
                # in remove mode the stdout line means "collected", so
                # a hash whose every path was spared is not printed
                print(hash_str)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # `find-unused-hashes SOURCES -- HASH_DIRS`: split at the separator
    # ourselves (argparse cannot split two variadic positionals).
    tail: list[str] = []
    if "--" in argv:
        idx = argv.index("--")
        argv, tail = argv[:idx], argv[idx + 1:]
    args = build_parser().parse_args(argv)
    if tail:
        if args.command != "find-unused-hashes":
            print("unexpected arguments after --", file=sys.stderr)
            return 2
        args.hashes = tail
    if args.command == "find-unused-hashes" and not args.hashes:
        print("find-unused-hashes requires hash directories after --",
              file=sys.stderr)
        return 2
    try:
        return asyncio.run(run(args))
    except ChunkyBitsError as err:
        print(err, file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        # Downstream closed (e.g. `cat ... | head`): die quietly like a
        # coreutils tool.  Point stdout at devnull so the interpreter's
        # exit-time flush doesn't raise a second time.  stdout may not be
        # backed by a real fd (captured/replaced in embedding harnesses);
        # still exit quietly then.
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        except (OSError, ValueError):
            # fileno() raises ValueError/io.UnsupportedOperation on a
            # replaced stdout; everything else here raises OSError
            pass
        return 141  # 128 + SIGPIPE


if __name__ == "__main__":
    sys.exit(main())
