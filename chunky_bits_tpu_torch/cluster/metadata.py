"""Durable file-reference store (the port of
``chunky_bits_tpu/cluster/metadata.py``).

Mirrors src/cluster/metadata.rs: tag-dispatched ``type: path`` /
``type: git`` stores (:42-92).  ``MetadataPath`` writes the serialized
FileReference under a root directory, optionally running a ``put_script``
via ``/bin/sh -c`` with ``fail_on_script_error`` (:94-141); listing is a
one-level directory scan with private->public path mapping (:152-205).
``MetadataGit`` wraps MetadataPath and runs ``git add`` + ``git commit`` per
write, denying ``.git`` paths (:223-328).  Formats: json, json-pretty
(default), json-strict, yaml — non-strict variants parse via YAML, a JSON
superset (:364-414).

The indexed ``type: meta-log`` store lives in cluster/meta_log.py.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Union

import yaml

from chunky_bits_tpu_torch.cluster import tunables
from chunky_bits_tpu_torch.errors import (
    LocationError,
    MetadataReadError,
    SerdeError,
)
from chunky_bits_tpu_torch.file import fsio as _fsio
from chunky_bits_tpu_torch.file.location import Location
from chunky_bits_tpu_torch.utils.yamlio import yaml_dump, yaml_load

JSON = "json"
JSON_PRETTY = "json-pretty"
JSON_STRICT = "json-strict"
YAML = "yaml"
FORMATS = (JSON, JSON_PRETTY, JSON_STRICT, YAML)


class MetadataFormat:
    """(metadata.rs:364-414)"""

    def __init__(self, name: str = JSON_PRETTY):
        if name not in FORMATS:
            raise SerdeError(f"unknown metadata format {name!r}")
        self.name = name

    def to_string(self, payload) -> str:
        if self.name in (JSON, JSON_STRICT):
            return json.dumps(payload, separators=(",", ":"))
        if self.name == JSON_PRETTY:
            return json.dumps(payload, indent=2)
        return yaml_dump(payload, sort_keys=False)

    def loader(self):
        """The raw bytes -> obj parse callable with the format branch
        hoisted, for batch consumers (the meta-log's
        ``namespace_snapshot``).  Raises the codec's own errors; batch
        callers wrap them in SerdeError once per batch."""
        return json.loads if self.name == JSON_STRICT else yaml_load

    def from_bytes(self, data: bytes):
        try:
            if self.name == JSON_STRICT:
                return json.loads(data)
            return yaml_load(data)
        except (json.JSONDecodeError, yaml.YAMLError) as err:
            raise SerdeError(str(err)) from err

    async def from_location(self, location: Union[str, Location],
                            cx=None):
        if not isinstance(location, Location):
            location = Location.parse(str(location))
        data = await location.read(cx)
        return self.from_bytes(data)


@dataclass
class FileOrDirectory:
    """(metadata.rs:417-506)"""

    kind: str  # "file" | "directory"
    path: str

    def is_file(self) -> bool:
        return self.kind == "file"

    def is_directory(self) -> bool:
        return self.kind == "directory"

    def __str__(self) -> str:
        return self.path

    @staticmethod
    async def from_local_path(path: str) -> "FileOrDirectory":
        if await asyncio.to_thread(os.path.isdir, path):
            return FileOrDirectory("directory", path)
        if await asyncio.to_thread(os.path.isfile, path):
            return FileOrDirectory("file", path)
        raise LocationError(f"not a file or directory: {path}")

    @staticmethod
    async def list(path: str) -> list["FileOrDirectory"]:
        """Top-level entry followed by its immediate children."""
        top = await FileOrDirectory.from_local_path(path)
        out = [top]
        if top.is_directory():

            def _scan() -> list[tuple[str, str]]:
                # one scandir pass: the dirent already carries the
                # entry type, so N children cost one getdents stream
                # instead of listdir + an isdir/isfile stat pair per
                # name (entries that are neither — sockets, dangling
                # links, raced unlinks — are skipped, same outcome as
                # from_local_path's LocationError)
                found = []
                with os.scandir(path) as it:
                    for entry in it:
                        try:
                            if entry.is_dir():
                                found.append(("directory", entry.name))
                            elif entry.is_file():
                                found.append(("file", entry.name))
                        except OSError:
                            continue
                found.sort(key=lambda t: t[1])
                return found

            # the scan rides the thread hop: eager, it would run on the
            # loop
            for kind, name in await asyncio.to_thread(_scan):
                out.append(FileOrDirectory(kind, os.path.join(path, name)))
        return out


def _sub_path(root: str, path: str) -> str:
    """Join, keeping only normal components (no traversal;
    metadata.rs:197-205)."""
    parts = [p for p in str(path).split("/")
             if p not in ("", ".", "..")]
    return os.path.join(root, *parts) if parts else root


def _pub_path(root: str, sub: str) -> str:
    """Strip the store root off a private path (metadata.rs:174-195)."""
    rel = os.path.relpath(sub, root)
    return "." if rel == "." else rel


#: a publication temp older than this is a crashed writer's leak (a
#: metadata write takes milliseconds; the margin covers a paused
#: writer) — reaped by the next write to the same directory, so a
#: crash between temp write and rename never leaks ``.tmp`` files
#: forever (the GC's dirent stale-temp reaper only walks chunk hash
#: dirs, never metadata roots)
STALE_TEMP_SECONDS = 60.0


def _reap_stale_temps(dirname: str) -> None:
    """Remove crashed writers' publication temps from one metadata
    directory (sync — runs inside the write's thread hop).  Age-gated:
    a concurrent writer's in-flight temp is younger than the threshold
    and survives; its rename needs nothing but the inode anyway.
    Called once per (MetadataPath instance, directory) — the scan is
    O(dir entries), and paying it per write would turn a million-object
    namespace walk quadratic (measured +1.5 ms/write at a mere 150
    entries on this box's 9p /tmp); a crashed writer's leak is reaped
    by the next PROCESS's first write there, which is what "reap on
    next write" can soundly mean without a per-write scan."""
    from chunky_bits_tpu_torch.file.location import is_publish_temp

    try:
        entries = os.listdir(dirname)
    except OSError:
        return
    # file mtimes are wall-clock; comparing them against anything else
    # would misclassify every temp inside a simulation
    # lint: clock-ok file mtimes are wall-clock; comparing them against
    # anything else would misclassify every temp inside a simulation
    now = time.time()
    for entry in entries:
        if not is_publish_temp(entry):
            continue
        path = os.path.join(dirname, entry)
        try:
            if now - os.path.getmtime(path) > STALE_TEMP_SECONDS:
                _fsio.unlink(path)
        except OSError:
            continue  # raced another reaper / already renamed away


class MetadataPath:
    """(metadata.rs:94-205)"""

    def __init__(self, path: str, format: Optional[MetadataFormat] = None,
                 put_script: Optional[str] = None,
                 fail_on_script_error: bool = False):
        self.path = str(path)
        self.format = format or MetadataFormat()
        self.put_script = put_script
        self.fail_on_script_error = fail_on_script_error
        #: directories whose stale publication temps this instance has
        #: already reaped (once per instance: see _reap_stale_temps);
        #: set add/contains are GIL-atomic, and a racing double-scan
        #: is merely redundant
        self._reaped_dirs: set[str] = set()

    async def write(self, path: str, payload) -> None:
        target = _sub_path(self.path, path)
        text = self.format.to_string(payload)

        def _write() -> None:
            # Atomic publication, like every other local write in this
            # repo (file/location._publish_atomically): the reference
            # truncates in place (metadata.rs:120-130), which lets a
            # concurrent reader observe an empty/torn reference — a
            # live hazard now that the scrub daemon republishes
            # metadata while clients read it.  Unlike the per-chunk
            # path, metadata publication is the cluster's WRITE
            # ACKNOWLEDGMENT, so it is made power-loss durable: temp
            # fsync before the rename, directory fsync after it (the
            # crash harness's powercut images pin both directions —
            # sim/crash.py, tests/test_crash.py).  A failing fsync
            # raises and ABORTS the publication; it is never swallowed
            # and assumed durable.
            from chunky_bits_tpu_torch.file.location import publish_temp_name

            dirname = os.path.dirname(target)
            _fsio.makedirs(dirname)
            if dirname not in self._reaped_dirs:
                self._reaped_dirs.add(dirname)
                _reap_stale_temps(dirname)
            tmp = publish_temp_name(target)
            try:
                with _fsio.open(tmp, "w") as f:
                    f.write(text)
                    _fsio.fsync(f)
                _fsio.replace(tmp, target)
                _fsio.fsync_dir(dirname)
            except BaseException:
                try:
                    _fsio.unlink(tmp)
                except OSError:
                    pass
                raise

        try:
            await asyncio.to_thread(_write)
        except OSError as err:
            raise MetadataReadError(str(err)) from err
        if self.put_script:
            proc = await asyncio.create_subprocess_shell(
                self.put_script, cwd=self.path)
            # a user-supplied local hook, unbounded on purpose: a timeout
            # would orphan a zombie and ack the write with the hook's
            # outcome unknown (reference parity: put_script blocks)
            # lint: unbounded-deadline-ok user-supplied local hook; a
            # timeout here would orphan a zombie and ack the write with
            # the hook's outcome unknown — runaway hooks are the
            # operator's contract (reference parity: put_script blocks)
            code = await proc.wait()
            if self.fail_on_script_error and code != 0:
                # Distinguish signal-death from a nonzero exit like the
                # reference's ExitCode/Signal variants (error.rs:236-253);
                # a negative returncode is -signum.
                if code < 0:
                    raise MetadataReadError(
                        f"put_script killed by signal {-code}")
                raise MetadataReadError(
                    f"put_script exited with code {code}")

    async def read(self, path: str):
        target = _sub_path(self.path, path)

        def _read() -> bytes:
            with open(target, "rb") as f:
                return f.read()

        try:
            data = await asyncio.to_thread(_read)
        except OSError as err:
            raise MetadataReadError(str(err)) from err
        return self.format.from_bytes(data)

    async def list(self, path: str) -> list[FileOrDirectory]:
        target = _sub_path(self.path, path)
        try:
            entries = await FileOrDirectory.list(target)
        except LocationError as err:
            raise MetadataReadError(str(err)) from err
        return [
            FileOrDirectory(e.kind, _pub_path(self.path, e.path))
            for e in entries
        ]

    def to_obj(self) -> dict:
        obj = {"type": "path", "format": self.format.name,
               "path": self.path}
        if self.put_script is not None:
            obj["put_script"] = self.put_script
        if self.fail_on_script_error:
            obj["fail_on_script_error"] = True
        return obj


def _deny_git(path: str) -> str:
    first = [p for p in str(path).split("/") if p not in ("", ".")]
    if first and first[0] == ".git":
        raise MetadataReadError("Access to .git is denied")
    return path


class MetadataGit:
    """(metadata.rs:208-329)"""

    def __init__(self, path: str, format: Optional[MetadataFormat] = None):
        self.meta_path = MetadataPath(path, format)

    @property
    def path(self) -> str:
        return self.meta_path.path

    @property
    def format(self) -> MetadataFormat:
        return self.meta_path.format

    async def _git(self, *args: str) -> None:
        proc = await asyncio.create_subprocess_exec(
            "git", *args, cwd=self.meta_path.path)
        # a local git child on a local repo, unbounded on purpose:
        # abandoning wait() would leak a zombie and race the next
        # add/commit against this one's index lock
        # lint: unbounded-deadline-ok local git child on a local repo;
        # abandoning wait() would leak a zombie and race the next
        # add/commit against this one's index lock
        code = await proc.wait()
        if code != 0:
            raise MetadataReadError(f"git {args[0]} exited with {code}")

    async def write(self, path: str, payload) -> None:
        _deny_git(path)
        await self.meta_path.write(path, payload)
        rel = "/".join(p for p in str(path).split("/")
                       if p not in ("", ".", ".."))
        await self._git("add", rel)
        await self._git("commit", "-m", f"Write {rel}")

    async def read(self, path: str):
        _deny_git(path)
        return await self.meta_path.read(path)

    async def list(self, path: str) -> list[FileOrDirectory]:
        _deny_git(path)
        entries = await self.meta_path.list(path)
        out = []
        for e in entries:
            try:
                _deny_git(e.path)
            except MetadataReadError:
                continue
            out.append(e)
        return out

    def to_obj(self) -> dict:
        return {"type": "git", "format": self.format.name,
                "path": self.path}


if TYPE_CHECKING:
    from chunky_bits_tpu_torch.cluster.meta_log import MetadataLog

MetadataStore = Union[MetadataPath, MetadataGit, "MetadataLog"]


def metadata_from_obj(obj: dict) -> MetadataStore:
    """Tag-dispatched deserialization (metadata.rs:42-48), plus the
    ``meta-log`` kind (cluster/meta_log.py); ``kind:`` is accepted as an
    alias for the tag.  ``$CHUNKY_BITS_TORCH_METADATA_KIND=meta-log``
    (read here, at cluster-config load) rebuilds plain ``type: path``
    stores as meta-logs over the same root; stores with a
    ``put_script`` stay ``path`` (the log has no per-write hook), as in
    the JAX package."""
    if not isinstance(obj, dict) or not ("type" in obj or "kind" in obj):
        raise SerdeError("metadata must be a mapping with a 'type' tag")
    kind = obj["type"] if "type" in obj else obj["kind"]
    fmt = MetadataFormat(obj["format"]) if "format" in obj else None
    if kind == "path":
        if (obj.get("put_script") is None
                and tunables.metadata_kind() == "meta-log"):
            from chunky_bits_tpu_torch.cluster.meta_log import MetadataLog

            return MetadataLog(path=obj["path"], format=fmt)
        return MetadataPath(
            path=obj["path"],
            format=fmt,
            put_script=obj.get("put_script"),
            fail_on_script_error=bool(obj.get("fail_on_script_error",
                                              False)),
        )
    if kind == "git":
        return MetadataGit(path=obj["path"], format=fmt)
    if kind == "meta-log":
        # lazy import: a plain path store never loads the log machinery
        from chunky_bits_tpu_torch.cluster.meta_log import MetadataLog

        return MetadataLog(path=obj["path"], format=fmt)
    raise SerdeError(f"unknown metadata type {kind!r}")
