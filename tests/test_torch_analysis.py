"""The port's invariant linter (chunky_bits_tpu_torch/analysis), held
against the JAX package's (chunky_bits_tpu/analysis).

The mirror of tests/test_analysis.py: per-rule must-flag and must-pass
fixture snippets, suppression-comment parsing, baseline round-trip, CLI
exit codes, and the gate itself (the port's tree as shipped is clean).
Every snippet and fixture tree goes through both linters under the same
relative path, and they must report the same ``(rule, line, scope)``
for every rule but CB102 (each watches its own package's env prefix) and
CB105 (the port's launch hygiene replaces the reference's jit hygiene);
those two have cases of their own.  The call-graph and CFG cases build
both packages' graphs and compare them.  Then three whole-tree cases:
the port's linter over the port, the reference's over the port, and the
port's over the JAX package.

Whole-tree CLI runs are shared between the cases that read them (a run
costs seconds), so each distinct invocation runs once per session.  No
torch or jax import anywhere in this file: the linter must run on a box
with neither.
"""

from __future__ import annotations

import functools
import json
import resource
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from chunky_bits_tpu.analysis import core as ref_core
from chunky_bits_tpu.analysis import rules as ref_rules
from chunky_bits_tpu_torch.analysis import core, rules

REPO = Path(__file__).resolve().parents[1]
PKG_ROOT = REPO / "chunky_bits_tpu_torch"
REF_ROOT = REPO / "chunky_bits_tpu"

#: rules whose meaning differs between the packages by design
DIVERGENT = ("CB102", "CB105")


def _where(violations) -> set:
    return {(v.rule, v.line, v.scope) for v in violations
            if v.rule not in DIVERGENT}


def _both(root: Path, select: tuple):
    """Run the port's and the reference's rule sets over ``root``; they
    must agree on every rule outside ``DIVERGENT``.  Returns the port's
    findings."""
    found = []
    for mod_core, mod_rules in ((core, rules), (ref_core, ref_rules)):
        ruleset = [r for r in mod_rules.ALL_RULES
                   if not select or r.id in select]
        violations, errors = mod_core.run_analysis(root, ruleset)
        assert not errors, errors
        found.append(violations)
    port, ref = found
    assert _where(port) == _where(ref), (sorted(_where(port)),
                                         sorted(_where(ref)))
    return port


def run_snippet(tmp_path: Path, rel: str, source: str,
                select: tuple[str, ...] = ()):
    """Lint one fixture file placed at ``rel`` under a scratch root
    (rule path scopes key off rel, e.g. 'ops/x.py') with both linters."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    return _both(tmp_path, select)


# ---- CB101 unbounded-await ----

def test_unbounded_await_flags_event_wait(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        async def f(evt):
            await evt.wait()
    """, select=("CB101",))
    assert [v.rule for v in vs] == ["CB101"]
    assert "no deadline" in vs[0].message


def test_unbounded_await_flags_bare_future(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        async def f(fut):
            return await fut
    """, select=("CB101",))
    assert [v.rule for v in vs] == ["CB101"]
    assert "bare future" in vs[0].message


def test_unbounded_await_passes_wait_for_and_plain_calls(tmp_path):
    vs = run_snippet(tmp_path, "gateway/x.py", """
        import asyncio

        async def f(evt, reader):
            await asyncio.wait_for(evt.wait(), 5.0)
            data = await reader.read(4096)
            await asyncio.sleep(1.0)
            return data
    """, select=("CB101",))
    assert vs == []


def test_unbounded_await_out_of_scope_paths_pass(tmp_path):
    # cluster/ at large is not a device/network call path (metadata
    # subprocess waits etc. are CLI-bounded); only the I/O-scheduler
    # modules below are in scope
    vs = run_snippet(tmp_path, "cluster/x.py", """
        async def f(evt):
            await evt.wait()
    """, select=("CB101",))
    assert vs == []


def test_unbounded_await_covers_io_scheduler_paths(tmp_path):
    """The hedged-read/write-failover modules are in the CB101 scope:
    every await the location race adds must stay reachable through a
    timeout."""
    for i, rel in enumerate(("file/file_part.py",
                             "cluster/destination.py",
                             "cluster/health.py")):
        vs = run_snippet(tmp_path / str(i), rel, """
            async def f(task):
                return await task
        """, select=("CB101",))
        assert [v.rule for v in vs] == ["CB101"], rel


# ---- CB102 env-flag-discipline ----

def test_env_read_flagged_outside_tunables(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        import os

        def f():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")
    """, select=("CB102",))
    assert [v.rule for v in vs] == ["CB102"]
    assert "CHUNKY_BITS_TORCH_FOO" in vs[0].message


def test_env_read_resolves_module_constants(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        import os

        KNOB = "CHUNKY_BITS_TORCH_BAR"

        def f():
            return os.environ[KNOB]
    """, select=("CB102",))
    assert [v.rule for v in vs] == ["CB102"]


def test_env_read_allowed_in_tunables_and_for_other_prefixes(tmp_path):
    assert run_snippet(tmp_path, "cluster/tunables.py", """
        import os

        def env_str(name):
            return os.environ.get(name, "")

        def f():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")
    """, select=("CB102",)) == []
    assert run_snippet(tmp_path, "ops/y.py", """
        import os

        def f():
            return os.environ.get("JAX_PLATFORMS")
    """, select=("CB102",)) == []


def test_env_read_watches_each_packages_own_prefix(tmp_path):
    """CB102 is the one CB1xx rule whose scope differs by design: the
    port's linter watches ``CHUNKY_BITS_TORCH_*`` and leaves the JAX
    package's ``CHUNKY_BITS_TPU_*`` alone (that package's knobs never
    reconfigure the port), and the reference's does the opposite."""
    path = tmp_path / "ops" / "x.py"
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent("""
        import os

        def f():
            return (os.environ.get("CHUNKY_BITS_TORCH_FOO"),
                    os.environ.get("CHUNKY_BITS_TPU_FOO"))
    """), encoding="utf-8")
    for mod_core, mod_rules, key in (
            (core, rules, "CHUNKY_BITS_TORCH_FOO"),
            (ref_core, ref_rules, "CHUNKY_BITS_TPU_FOO")):
        vs, errors = mod_core.run_analysis(
            tmp_path, [r for r in mod_rules.ALL_RULES if r.id == "CB102"])
        assert not errors, errors
        assert [(v.rule, v.line, v.col) for v in vs] == [
            ("CB102", 5 if key.endswith("TORCH_FOO") else 6, 12)], key
        assert key in vs[0].message
    assert rules.ENV_PREFIX == "CHUNKY_BITS_TORCH_"


def test_env_write_not_flagged(tmp_path):
    vs = run_snippet(tmp_path, "cli/x.py", """
        import os

        def f(v):
            os.environ["CHUNKY_BITS_TORCH_BACKEND"] = v
    """, select=("CB102",))
    assert vs == []


# ---- CB103 non-daemon-thread ----

def test_thread_rule_flags_pool_and_nondaemon_thread(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        def f(fn):
            pool = ThreadPoolExecutor(max_workers=2)
            t = threading.Thread(target=fn)
            return pool, t
    """, select=("CB103",))
    assert [v.rule for v in vs] == ["CB103", "CB103"]


def test_thread_rule_passes_daemon_thread_and_other_paths(tmp_path):
    assert run_snippet(tmp_path, "ops/x.py", """
        import threading

        def f(fn):
            return threading.Thread(target=fn, daemon=True)
    """, select=("CB103",)) == []
    # file/ (other than chunk_cache) is out of scope for CB103
    assert run_snippet(tmp_path, "file/x.py", """
        from concurrent.futures import ThreadPoolExecutor

        def f():
            return ThreadPoolExecutor()
    """, select=("CB103",)) == []


# ---- CB104 broad-except ----

def test_broad_except_flagged_without_justification(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        def f():
            try:
                return 1
            except Exception:
                return None
    """, select=("CB104",))
    assert [v.rule for v in vs] == ["CB104"]


def test_broad_except_terminal_raise_passes(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        def f():
            try:
                return 1
            except Exception as err:
                raise RuntimeError("wrapped") from err
    """, select=("CB104",))
    assert vs == []


def test_broad_except_narrow_type_passes(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        def f():
            try:
                return 1
            except (OSError, ValueError):
                return None
    """, select=("CB104",))
    assert vs == []


def test_broad_except_bare_and_tuple_flagged(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        def f():
            try:
                return 1
            except (ValueError, Exception):
                return None

        def g():
            try:
                return 1
            except:  # noqa: E722
                return None
    """, select=("CB104",))
    assert len(vs) == 2


def test_noqa_ble001_with_reason_accepted(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        def f():
            try:
                return 1
            except Exception as err:  # noqa: BLE001 — surfaced upstream
                return err
    """, select=("CB104",))
    assert vs == []


# ---- CB105 launch hygiene (the port's own; the reference's CB105 is
# jit-body hygiene for its XLA backend) ----

def test_launch_hygiene_flags_data_ptr_of_strided_tensor(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        def launch(fn, table, shards, out):
            view = shards[:, 1:]
            return fn(table.data_ptr(), view.data_ptr(), out.data_ptr())
    """, select=("CB105",))
    assert [(v.rule, v.line) for v in vs] == [("CB105", 4)] * 3
    assert "contiguous" in vs[0].message


def test_launch_hygiene_passes_dense_tensors(tmp_path):
    # the shapes of ops/gf_kernel.py::_launch and reduce_pack and of
    # ops/sha256.py::sha256_parts: reassigned .contiguous(), fresh
    # allocations, an optional second source, a list of dense partials
    # and a closure over them
    vs = run_snippet(tmp_path, "ops/x.py", """
        import ctypes

        import torch

        def launch(fn, table, shards, b, partials):
            out = torch.empty((4, 4), dtype=torch.uint8)
            acc = shards.new_zeros((4,))
            table = table.contiguous()
            b = None if b is None else b.contiguous()
            parts = [p.contiguous() for p in partials]
            ptrs = (ctypes.c_void_p * len(parts))(
                *[p.data_ptr() for p in parts])

            def go():
                return fn(table.data_ptr(), out.data_ptr())

            err = fn(table.data_ptr(), shards.contiguous().data_ptr(),
                     None if b is None else b.data_ptr(),
                     out.data_ptr(), acc.data_ptr(), ptrs)
            return err, go()
    """, select=("CB105",))
    assert vs == []


def test_launch_hygiene_flags_discarded_kernel_return_code(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        def launch(name, a):
            fn, error_string = _library(name)
            fn(a, 1)
            err = fn(a, 2)
            return err

        def launch_sha(a):
            lib = _library()
            lib.cb_sha256_rows(a, 1)
            if lib.cb_sha256_rows(a, 2) != 0:
                raise RuntimeError(a)
    """, select=("CB105",))
    assert [(v.rule, v.line) for v in vs] == [("CB105", 4),
                                              ("CB105", 10)]
    assert "return code" in vs[0].message
    # building and loading a library is not a launch
    assert run_snippet(tmp_path / "warm", "ops/y.py", """
        def warm(gf_kernel):
            gf_kernel._library("gf_apply")
            _library()
    """, select=("CB105",)) == []


def test_launch_hygiene_flags_in_place_write_through_from_numpy(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        import torch

        def stage(arr, src, pin):
            t = torch.from_numpy(arr)
            t.copy_(src)
            t.bitwise_xor_(src)
            t[0] = 1
            t ^= src
            torch.add(src, src, out=t)
            torch.from_numpy(arr).copy_(pin)
            return t
    """, select=("CB105",))
    assert [v.line for v in vs] == [6, 7, 8, 9, 10, 11]
    assert {v.rule for v in vs} == {"CB105"}
    assert "caller" in vs[0].message


def test_launch_hygiene_passes_reads_and_copies_of_from_numpy(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        import torch

        def stage(arr, dev, src):
            t = torch.from_numpy(arr)
            on_dev = torch.from_numpy(arr).to(dev)
            mine = t.clone()
            mine.copy_(src)
            mine[0] = 1
            return t.sum(), on_dev, mine

        def own_output(dst, pin):
            # lint: launch-hygiene-ok dst is this function's own result
            torch.from_numpy(dst).copy_(pin)
    """, select=("CB105",))
    assert vs == []


def test_xor_schedule_module_is_in_cb101_cb105_scope(tmp_path):
    """The scheduled-XOR engine (ops/xor_schedule.py) sits on the
    host codec's dispatch path: it must stay inside both the
    bounded-wait (CB101) and launch-hygiene (CB105) scopes — and the
    shipped module itself must be clean with zero baseline entries
    (test_shipped_tree_is_clean covers the latter tree-wide)."""
    for rid, src in (("CB101", """
        async def f(task):
            return await task
    """), ("CB105", """
        def f(fn, a):
            return fn(a.data_ptr())
    """)):
        vs = run_snippet(tmp_path / rid, "ops/xor_schedule.py", src,
                         select=(rid,))
        assert [v.rule for v in vs] == [rid], rid


def test_mesh_modules_are_in_cb101_cb105_scope(tmp_path):
    """The mesh backend and its dispatch pipeline ARE the device
    dispatch path: both must sit inside the bounded-wait (CB101) and
    launch-hygiene (CB105) scopes.  Must-flag fixtures per module per
    rule; the shipped modules themselves are clean with zero baseline
    entries (test_shipped_tree_is_clean pins that tree-wide).  Outside
    ops/ and parallel/ CB105 does not apply."""
    for rel in ("ops/mesh_backend.py", "ops/dispatch_pipeline.py"):
        for rid, src in (("CB101", """
            async def f(task):
                return await task
        """), ("CB105", """
            def f(fn, a):
                return fn(a.data_ptr())
        """)):
            vs = run_snippet(tmp_path / rid / rel.replace("/", "_"),
                             rel, src, select=(rid,))
            assert [v.rule for v in vs] == [rid], (rel, rid)
        # and the bounded idioms the shipped modules actually use pass:
        # window sync is a plain (non-async) lock — nothing for CB101
        vs = run_snippet(tmp_path / "ok" / rel.replace("/", "_"), rel,
                         """
            import threading

            def drain(lock: threading.Lock, entries: list) -> None:
                with lock:
                    entries.clear()
        """, select=("CB101", "CB105"))
        assert vs == [], rel
    assert run_snippet(tmp_path / "out", "file/x.py", """
        def f(fn, a):
            return fn(a.data_ptr())
    """, select=("CB105",)) == []


# ---- CB106 public-annotations ----

def test_missing_annotations_flagged_on_strict_module(tmp_path):
    vs = run_snippet(tmp_path, "ops/backend.py", """
        class Coder:
            def encode(self, data):
                return data

        def helper(x) -> int:
            return x
    """, select=("CB106",))
    # encode: params + return; helper: params only
    assert sorted(v.message.split()[2] for v in vs) == [
        "encode()", "encode()", "helper()"]


def test_private_and_nonstrict_modules_pass(tmp_path):
    assert run_snippet(tmp_path, "ops/backend.py", """
        def _internal(x):
            return x
    """, select=("CB106",)) == []
    assert run_snippet(tmp_path, "ops/other.py", """
        def public(x):
            return x
    """, select=("CB106",)) == []


# ---- CB108 clock-seam ----

def test_clock_rule_flags_direct_monotonic_in_scope(tmp_path):
    vs = run_snippet(tmp_path, "cluster/x.py", """
        import time

        def f():
            return time.monotonic()
    """, select=("CB108",))
    assert [v.rule for v in vs] == ["CB108"]
    assert "clock seam" in vs[0].message


def test_clock_rule_flags_time_time_and_loop_time(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        import asyncio
        import time

        def stamp():
            return time.time()

        async def deadline():
            loop = asyncio.get_running_loop()
            return loop.time() + 30.0
    """, select=("CB108",))
    assert [v.rule for v in vs] == ["CB108", "CB108"]


def test_clock_rule_out_of_scope_and_seam_module_pass(tmp_path):
    # the seam module itself is the one sanctioned home for direct
    # reads; ops/ outside batching.py and other planes are out of scope
    assert run_snippet(tmp_path, "cluster/clock.py", """
        import time

        def monotonic():
            return time.monotonic()
    """, select=("CB108",)) == []
    assert run_snippet(tmp_path, "ops/backend.py", """
        import time

        def f():
            return time.monotonic()
    """, select=("CB108",)) == []


def test_clock_rule_flags_alias_import_spellings(tmp_path):
    # the CB102 convention: renamed imports must not slip past the lint
    vs = run_snippet(tmp_path, "cluster/x.py", """
        import time as t
        from time import monotonic
        from time import perf_counter as pc

        def f():
            return t.monotonic() + monotonic() + pc()
    """, select=("CB108",))
    assert [v.rule for v in vs] == ["CB108", "CB108", "CB108"]


def test_clock_rule_passes_non_loop_time_methods(tmp_path):
    # a .time() on an arbitrary call result is NOT loop.time(): only
    # event-loop getters count as the call-result spelling
    assert run_snippet(tmp_path, "cluster/x.py", """
        import datetime

        def f():
            return datetime.datetime.now().time()
    """, select=("CB108",)) == []


def test_clock_rule_suppression_with_reason(tmp_path):
    assert run_snippet(tmp_path, "file/x.py", """
        import time

        def publish_stamp():
            # lint: clock-ok wall-clock stamp for humans
            return time.time()
    """, select=("CB108",)) == []


def test_clock_rule_passes_seam_reads(tmp_path):
    assert run_snippet(tmp_path, "cluster/x.py", """
        from chunky_bits_tpu_torch.cluster import clock as _clock

        def f():
            return _clock.monotonic()
    """, select=("CB108",)) == []


# ---- CB109 fsio-seam ----

def test_fsio_rule_flags_direct_os_verbs_in_scope(tmp_path):
    vs = run_snippet(tmp_path, "file/slab.py", """
        import os

        def swap(tmp, target, root):
            os.replace(tmp, target)
            os.fsync(3)
            os.unlink(tmp)
    """, select=("CB109",))
    assert [v.rule for v in vs] == ["CB109", "CB109", "CB109"]
    assert "filesystem seam" in vs[0].message


def test_fsio_rule_flags_write_mode_open_only(tmp_path):
    vs = run_snippet(tmp_path, "cluster/metadata.py", """
        def publish(path, data):
            with open(path, "wb") as f:
                f.write(data)

        def probe(path):
            with open(path, "rb") as f:
                return f.read(1)

        def default_mode_read(path):
            with open(path) as f:
                return f.read()
    """, select=("CB109",))
    assert [v.rule for v in vs] == ["CB109"]
    assert "write-mode open" in vs[0].message


def test_fsio_rule_out_of_scope_modules_pass(tmp_path):
    # the seam applies to the storage-plane modules, not the whole tree
    assert run_snippet(tmp_path, "gateway/http.py", """
        import os

        def f(a, b):
            os.replace(a, b)
    """, select=("CB109",)) == []


def test_fsio_rule_passes_seam_calls_and_suppressions(tmp_path):
    assert run_snippet(tmp_path, "file/location.py", """
        from chunky_bits_tpu_torch.utils import fsio as _fsio

        def publish(tmp, target):
            with _fsio.open(tmp, "wb") as f:
                f.write(b"x")
                _fsio.fsync(f)
            _fsio.replace(tmp, target)
    """, select=("CB109",)) == []
    assert run_snippet(tmp_path, "file/slab.py", """
        import os

        def lock_fd(path):
            # lint: fsio-ok the flock target carries no data
            return os.open(path, os.O_CREAT | os.O_RDWR)
    """, select=("CB109",)) == []


def test_fsio_rule_covers_repair_and_scrub(tmp_path):
    """The repair planner's in-place rewrite path is in the scope: any
    future direct disk op there must surface."""
    for i, rel in enumerate(("cluster/repair.py", "cluster/scrub.py")):
        vs = run_snippet(tmp_path / str(i), rel, """
            import os

            def rewrite(tmp, target):
                os.replace(tmp, target)
        """, select=("CB109",))
        assert [v.rule for v in vs] == ["CB109"], rel


# ---- CB201 async-blocking ----

def test_async_blocking_flags_sleep_open_subprocess(tmp_path):
    vs = run_snippet(tmp_path, "gateway/x.py", """
        import subprocess
        import time

        async def handler(path):
            time.sleep(1.0)
            with open(path) as f:
                data = f.read()
            subprocess.run(["sync"])
            return data
    """, select=("CB201",))
    assert [v.rule for v in vs] == ["CB201"] * 3
    assert "time.sleep" in vs[0].message
    assert "open" in vs[1].message
    assert "subprocess.run" in vs[2].message


def test_async_blocking_flags_eager_args_of_to_thread(tmp_path):
    # os.listdir(path) as an ARGUMENT runs on the loop before the hop
    vs = run_snippet(tmp_path, "cluster/x.py", """
        import asyncio
        import os

        async def ls(path):
            return await asyncio.to_thread(sorted, os.listdir(path))
    """, select=("CB201",))
    assert [v.rule for v in vs] == ["CB201"]
    assert "os.listdir" in vs[0].message


def test_async_blocking_passes_offloaded_and_nested_sync(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        import asyncio
        import os

        async def ok(path):
            # callable passed, not called: runs on the worker
            f = await asyncio.to_thread(open, path, "rb")
            names = await asyncio.to_thread(os.listdir, path)
            return f, names

        async def nested(path, data):
            def _write():
                with open(path, "wb") as f:
                    f.write(data)
            await asyncio.to_thread(_write)

        def sync_code(path):
            return open(path).read()
    """, select=("CB201",))
    assert vs == []


# ---- CB202 lock-across-await ----

def test_lock_across_await_flagged(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            async def bad(self, fetch):
                with self._lock:
                    return await fetch()
    """, select=("CB202",))
    assert [v.rule for v in vs] == ["CB202"]
    assert "_lock" in vs[0].message


def test_lock_across_await_resolves_bare_import(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        from threading import Lock

        guard = Lock()

        async def bad(fetch):
            with guard:
                return await fetch()
    """, select=("CB202",))
    assert [v.rule for v in vs] == ["CB202"]


def test_lock_across_await_flags_implicit_suspensions(tmp_path):
    """async for / async with suspend without an ast.Await node; the
    lock is held across the suspension all the same."""
    vs = run_snippet(tmp_path, "file/x.py", """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            async def bad_for(self, stream):
                with self._lock:
                    async for chunk in stream:
                        self.total += len(chunk)

            async def bad_with(self, resource):
                with self._lock:
                    async with resource:
                        return self.total
    """, select=("CB202",))
    assert [v.rule for v in vs] == ["CB202", "CB202"]


def test_lock_across_await_passes_safe_shapes(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        import asyncio
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._alock = asyncio.Lock()

            async def ok(self, fetch):
                with self._lock:
                    snapshot = self.x  # sync-only critical section
                return await fetch(snapshot)

            async def ok_async_lock(self, fetch):
                async with self._alock:
                    return await fetch()

            async def ok_nested_def(self, fetch):
                with self._lock:
                    async def later():
                        await fetch()  # runs after release
                    return later
    """, select=("CB202",))
    assert vs == []


# ---- CB203 task-leak ----

def test_fire_and_forget_task_flagged(tmp_path):
    vs = run_snippet(tmp_path, "gateway/x.py", """
        import asyncio

        async def spawny(work, loop):
            asyncio.create_task(work())
            asyncio.ensure_future(work())
            loop.create_task(work())
    """, select=("CB203",))
    assert [v.rule for v in vs] == ["CB203"] * 3


def test_stored_awaited_and_callbacked_tasks_pass(tmp_path):
    vs = run_snippet(tmp_path, "gateway/x.py", """
        import asyncio

        async def ok(work, registry):
            t = asyncio.create_task(work())
            registry.append(asyncio.ensure_future(work()))
            await asyncio.create_task(work())
            asyncio.create_task(work()).add_done_callback(print)
            return t
    """, select=("CB203",))
    assert vs == []


# ---- CB204 cross-plane (the call-graph pass) ----

def test_cross_plane_flags_event_set_via_thread_target(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        import asyncio
        import threading

        class Pipe:
            def __init__(self):
                self.done = asyncio.Event()
                self._t = threading.Thread(
                    target=self._worker_body, daemon=True)

            def _worker_body(self):
                self.finish()

            def finish(self):
                self.done.set()
    """, select=("CB204",))
    assert [v.rule for v in vs] == ["CB204"]
    assert "asyncio.Event" in vs[0].message and "finish" in vs[0].message


def test_cross_plane_flags_loop_bound_class_via_job_lambda(tmp_path):
    # lambda handed to _Job + LOOP_BOUND tag inheritance by base name
    vs = run_snippet(tmp_path, "parallel/x.py", """
        class Batcher:
            LOOP_BOUND = True

            def poke(self):
                pass

        class SubBatcher(Batcher):
            pass

        def stage(pipe, data):
            b = SubBatcher()
            pipe.submit("encode", lambda: b.poke())
    """, select=("CB204",))
    assert [v.rule for v in vs] == ["CB204"]
    assert "LOOP_BOUND" in vs[0].message


def test_cross_plane_flags_callable_via_pipeline_run(tmp_path):
    """The async product path hands compute to workers through
    ``await pipeline.run(stage, fn)`` — those callables are roots too."""
    vs = run_snippet(tmp_path, "file/x.py", """
        import asyncio

        class Cache:
            LOOP_BOUND = True

            def get(self, key):
                return None

        async def serve(pipe, key):
            cache = Cache()
            return await pipe.run("verify", lambda: cache.get(key))
    """, select=("CB204",))
    assert [v.rule for v in vs] == ["CB204"]
    assert "cache.get" in vs[0].message


def test_cross_plane_flags_call_soon_from_decorated_to_thread_target(
        tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        import asyncio
        import functools

        @functools.lru_cache(None)
        def hop(loop, fn):
            loop.call_soon(fn)

        async def go(loop, fn):
            await asyncio.to_thread(hop, loop, fn)
    """, select=("CB204",))
    assert [v.rule for v in vs] == ["CB204"]
    assert "call_soon" in vs[0].message


def test_cross_plane_passes_threadsafe_doors_and_thread_event(tmp_path):
    vs = run_snippet(tmp_path, "parallel/x.py", """
        import asyncio
        import threading

        class Pipe:
            def __init__(self):
                self._done = threading.Event()
                self._t = threading.Thread(
                    target=self._worker_body, daemon=True)

            def _worker_body(self):
                self._done.set()  # threading.Event: thread-safe

            def bridge(self, loop, fn, coro):
                loop.call_soon_threadsafe(fn)
                asyncio.run_coroutine_threadsafe(coro(), loop)

        def make(pipe):
            job = pipe.submit("hash", lambda: 1)
            job.add_done_callback(pipe.bridge)
    """, select=("CB204",))
    assert vs == []


def test_cross_plane_ignores_unreachable_loop_code(tmp_path):
    # the same loop-bound touches OFF the worker graph are fine
    vs = run_snippet(tmp_path, "parallel/x.py", """
        import asyncio

        class Pipe:
            def __init__(self):
                self.done = asyncio.Event()

            async def on_loop(self):
                self.done.set()
    """, select=("CB204",))
    assert vs == []


# ---- CB205 loop-shared ----

def test_loop_shared_flags_module_and_class_mutables(tmp_path):
    vs = run_snippet(tmp_path, "gateway/x.py", """
        import asyncio
        from collections import OrderedDict

        _registry = {}
        _queue = asyncio.Queue()

        class Handler:
            seen = OrderedDict()
    """, select=("CB205",))
    assert [v.rule for v in vs] == ["CB205"] * 3
    assert "dict literal" in vs[0].message
    assert "loop-bound" in vs[1].message
    assert "class-level" in vs[2].message


def test_loop_shared_passes_safe_and_out_of_scope(tmp_path):
    assert run_snippet(tmp_path, "parallel/x.py", """
        import threading

        _LOCK = threading.Lock()
        _NAMES = ("a", "b")
        __all__ = ["x"]
        # lint: loop-shared-ok process-wide singleton guarded by _LOCK
        _cache = {}
    """, select=("CB205",)) == []
    # ops/ and cluster/ are out of scope for CB205
    assert run_snippet(tmp_path, "ops/x.py", """
        _REGISTRY = {}
    """, select=("CB205",)) == []


# ---- suppression parsing ----

def test_suppression_same_line_and_line_above(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        async def f(evt, fut):
            # lint: unbounded-await-ok winner always sets the event
            await evt.wait()
            return await fut  # lint: unbounded-await-ok drain resolves it
    """, select=("CB101",))
    assert vs == []


def test_suppression_skips_continuation_comment_lines(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        async def f(evt):
            # lint: unbounded-await-ok a justification long enough to
            # wrap over two comment lines still covers the next code line
            await evt.wait()
    """, select=("CB101",))
    assert vs == []


def test_suppression_without_reason_does_not_suppress(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        async def f(evt):
            await evt.wait()  # lint: unbounded-await-ok
    """, select=("CB101",))
    assert len(vs) == 1


def test_suppression_wrong_slug_does_not_suppress(tmp_path):
    vs = run_snippet(tmp_path, "ops/x.py", """
        async def f(evt):
            await evt.wait()  # lint: broad-except-ok wrong rule
    """, select=("CB101",))
    assert len(vs) == 1


# ---- baseline round-trip ----

def _sample_violations(tmp_path):
    return run_snippet(tmp_path, "ops/x.py", """
        import os

        def f():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")

        def g():
            try:
                return f()
            except Exception:
                return None
    """)


def test_baseline_round_trip(tmp_path):
    vs = _sample_violations(tmp_path)
    assert len(vs) == 2
    baseline_path = tmp_path / "baseline.toml"
    core.write_baseline(baseline_path, vs)
    accepted = core.load_baseline(baseline_path)
    assert accepted == {v.key() for v in vs}
    # every finding baselined -> nothing new
    assert [v for v in vs if v.key() not in accepted] == []


def test_baseline_minimal_parser_matches_tomli(tmp_path):
    vs = _sample_violations(tmp_path)
    baseline_path = tmp_path / "baseline.toml"
    core.write_baseline(baseline_path, vs)
    text = baseline_path.read_text(encoding="utf-8")
    mini = core._parse_minimal_toml(text)
    assert {(e["rule"], e["path"], e["fingerprint"])
            for e in mini["violation"]} == {v.key() for v in vs}


def test_baseline_fingerprint_survives_line_motion(tmp_path):
    before = _sample_violations(tmp_path)
    after = run_snippet(tmp_path, "ops/x.py", """
        import os

        # an unrelated comment pushed everything down


        def f():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")

        def g():
            try:
                return f()
            except Exception:
                return None
    """)
    assert {v.key() for v in before} == {v.key() for v in after}
    assert [v.line for v in before] != [v.line for v in after]


def test_missing_baseline_is_empty(tmp_path):
    assert core.load_baseline(tmp_path / "nope.toml") == set()


def test_corrupt_baseline_raises_clean_diagnostic(tmp_path):
    """A hand-edit typo must fail loudly with the file named, never as
    a raw decoder traceback or a silently-shrunk accepted set."""
    bad = tmp_path / "baseline.toml"
    bad.write_text('[[violation]]\nrule = "unterminated\n',
                   encoding="utf-8")
    with pytest.raises(ValueError, match="baseline .*unparseable"):
        core.load_baseline(bad)
    # a one-file tree: the scan before the baseline load stays short
    scratch = tmp_path / "pkg"
    (scratch / "ops").mkdir(parents=True)
    (scratch / "ops" / "m.py").write_text("X = 1\n", encoding="utf-8")
    proc = _run_cli("--root", str(scratch), "--baseline", str(bad))
    assert proc.returncode == 2
    assert "unparseable" in proc.stderr


def test_files_outside_root_are_an_error_not_a_silent_skip(tmp_path):
    """A file whose rel path can't resolve against --root would dodge
    every path-scoped rule; that's an error, not a clean scan."""
    outside = tmp_path / "backend.py"
    outside.write_text(
        "import threading\n\n\ndef f(fn):\n"
        "    return threading.Thread(target=fn)\n", encoding="utf-8")
    root = tmp_path / "pkg"
    root.mkdir()
    violations, errors = core.run_analysis(root, rules.ALL_RULES,
                                           files=[outside])
    assert violations == []
    assert len(errors) == 1 and "outside --root" in errors[0]


def test_unparseable_file_is_an_error_not_a_skip(tmp_path):
    path = tmp_path / "ops" / "bad.py"
    path.parent.mkdir(parents=True)
    path.write_text("def broken(:\n", encoding="utf-8")
    violations, errors = core.run_analysis(tmp_path, rules.ALL_RULES)
    assert violations == []
    assert len(errors) == 1 and "bad.py" in errors[0]


def _run_cli(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "chunky_bits_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=120,
        cwd=cwd or str(PKG_ROOT.parent))


def _child_cpu_seconds() -> float:
    """CPU seconds (user + system) of this process's waited-for children:
    the analyzer's own cost, whatever else loads the box."""
    usage = resource.getrusage(resource.RUSAGE_CHILDREN)
    return usage.ru_utime + usage.ru_stime


@functools.lru_cache(maxsize=None)
def _shipped(*args):
    """``(process, CPU seconds)`` of one CLI run over the shipped tree,
    run once per session and shared by every case that reads it."""
    t0 = _child_cpu_seconds()
    proc = _run_cli(*args)
    return proc, _child_cpu_seconds() - t0


#: runs ``python -m chunky_bits_tpu_torch.analysis --json --graph-stats``
#: through runpy (what ``-m`` does) in a fresh interpreter, then reports
#: which heavy modules the full in-process analysis pulled in
_JSON_RUN = """
import json, runpy, sys
sys.argv = ["analysis", "--json", "--graph-stats"]
try:
    runpy.run_module("chunky_bits_tpu_torch.analysis", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as stop:
    rc = stop.code
heavy = [m for m in ("jax", "torch", "numpy", "aiohttp") if m in sys.modules]
print(json.dumps({"rc": rc, "heavy": heavy}))
"""


@functools.lru_cache(maxsize=None)
def _shipped_json() -> dict:
    """The full ``--json --graph-stats`` report over the shipped tree:
    the payload, the exit code, the heavy modules loaded and the CPU
    seconds, from one run shared by the cases that read it."""
    t0 = _child_cpu_seconds()
    proc = subprocess.run([sys.executable, "-c", _JSON_RUN],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(PKG_ROOT.parent))
    elapsed = _child_cpu_seconds() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report, tail = proc.stdout.strip().splitlines()[-2:]
    return {"payload": json.loads(report), **json.loads(tail),
            "seconds": elapsed}


@pytest.mark.filterwarnings("ignore")
def test_shipped_tree_is_clean():
    """THE acceptance gate: the analyzer exits 0 on the port's tree as
    shipped.  A new violation anywhere in chunky_bits_tpu_torch/ fails
    tier-1 right here."""
    proc, _ = _shipped("--graph-stats")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok:" in proc.stdout


def test_cli_fails_on_introduced_violation(tmp_path):
    """End-to-end: introducing a fixture violation into a scanned tree
    turns the exit code non-zero (the gate's contract)."""
    scratch = tmp_path / "pkg"
    (scratch / "ops").mkdir(parents=True)
    (scratch / "ops" / "fresh.py").write_text(
        "import os\n\n\ndef f():\n"
        "    return os.environ.get('CHUNKY_BITS_TORCH_NEW_KNOB')\n",
        encoding="utf-8")
    proc = _run_cli("--root", str(scratch), "--baseline",
                    str(tmp_path / "empty.toml"))
    assert proc.returncode == 1
    assert "CB102" in proc.stdout


def test_cli_write_baseline_refuses_restricted_scans(tmp_path):
    """A --select/path-restricted scan sees only a subset of findings;
    writing that subset out would drop every accepted entry outside it
    (and the next full run would fail on the re-surfaced findings)."""
    for args in (("--select", "CB101", "--write-baseline"),
                 (str(PKG_ROOT / "file"), "--write-baseline")):
        proc = _run_cli(*args, "--baseline", str(tmp_path / "b.toml"))
        assert proc.returncode == 2
        assert "full scan" in proc.stderr
        assert not (tmp_path / "b.toml").exists()


def test_cli_write_baseline_refuses_scan_with_file_errors(tmp_path):
    """An unparseable file's accepted findings are missing from the
    scan; writing the baseline anyway would drop them silently."""
    scratch = tmp_path / "pkg"
    (scratch / "ops").mkdir(parents=True)
    (scratch / "ops" / "bad.py").write_text("def broken(:\n",
                                            encoding="utf-8")
    proc = _run_cli("--root", str(scratch), "--write-baseline",
                    "--baseline", str(tmp_path / "b.toml"))
    assert proc.returncode == 2
    assert "file errors" in proc.stderr
    assert not (tmp_path / "b.toml").exists()


def test_cli_list_rules_names_every_rule_grouped_by_family():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rid in ("CB101", "CB102", "CB103", "CB104", "CB105", "CB106",
                "CB107", "CB108", "CB109",
                "CB201", "CB202", "CB203", "CB204", "CB205",
                "CB301", "CB302", "CB303", "CB304", "CB305",
                "CB401", "CB402", "CB403", "CB404", "CB405"):
        assert rid in proc.stdout
    # family grouping with one-line hazard descriptions
    assert "CB1xx — " in proc.stdout
    assert "CB2xx — " in proc.stdout
    assert "CB3xx — " in proc.stdout
    assert "CB4xx — " in proc.stdout
    assert proc.stdout.index("CB1xx") < proc.stdout.index("CB101")
    assert proc.stdout.index("CB2xx") < proc.stdout.index("CB201")
    assert proc.stdout.index("CB3xx") < proc.stdout.index("CB301")
    assert proc.stdout.index("CB4xx") < proc.stdout.index("CB401")


def test_cli_select_family_prefix():
    """--select CB2 selects the whole CB2xx family, and exits 0 on the
    shipped tree."""
    proc = _run_cli("--select", "CB2", "--list-rules")
    assert proc.returncode == 0
    assert "CB201" in proc.stdout and "CB205" in proc.stdout
    assert "CB101" not in proc.stdout
    proc, _ = _shipped("--select", "CB2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _run_cli("--select", "CB9")
    assert proc.returncode == 2
    assert "unknown rule ids" in proc.stderr
    # empty tokens must not silently select every rule
    proc = _run_cli("--select", "CB2,", "--list-rules")
    assert proc.returncode == 0
    assert "CB101" not in proc.stdout
    proc = _run_cli("--select", ",")
    assert proc.returncode == 2


def test_cli_json_contract():
    run = _shipped_json()
    assert run["rc"] == 0
    payload = run["payload"]
    assert payload["ok"] is True
    assert payload["new"] == []


def test_cli_json_reports_rule_family(tmp_path):
    scratch = tmp_path / "pkg"
    (scratch / "gateway").mkdir(parents=True)
    (scratch / "gateway" / "fresh.py").write_text(
        "import asyncio\n\n\nasync def f(work):\n"
        "    asyncio.create_task(work())\n", encoding="utf-8")
    proc = _run_cli("--root", str(scratch), "--baseline",
                    str(tmp_path / "empty.toml"), "--json")
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert [v["rule_family"] for v in payload["new"]] == ["CB2xx"]
    assert payload["new"][0]["rule"] == "CB203"


# ---- CB3xx whole-program reachability family ----

def run_tree(tmp_path: Path, files: dict, select: tuple = ()):
    """Lint a multi-file fixture tree (the CB3xx rules are
    interprocedural: roots and flagged sites live in different
    modules)."""
    for rel, source in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source), encoding="utf-8")
    return _both(tmp_path, select)


# -- CB301 fsio-escape --

def test_fsio_escape_flags_reachable_offseam_helper(tmp_path):
    """The hole CB109 cannot see: os.replace extracted into a utils/
    helper that a durability root still reaches cross-module."""
    vs = run_tree(tmp_path, {
        "file/slab.py": """
            from utils import misc

            class SlabStore:
                def append(self, a, b):
                    misc.swap(a, b)
        """,
        "utils/misc.py": """
            import os

            def swap(a, b):
                os.replace(a, b)
        """,
    }, select=("CB301",))
    assert [(v.rule, v.path) for v in vs] == \
        [("CB301", "utils/misc.py")]
    assert "os.replace()" in vs[0].message
    assert "crash harness" in vs[0].message


def test_fsio_escape_passes_unreachable_and_governed(tmp_path):
    # same off-seam helper, but nothing on a durability path calls it
    assert run_tree(tmp_path, {
        "file/slab.py": """
            class SlabStore:
                def append(self, a, b):
                    return (a, b)
        """,
        "utils/misc.py": """
            import os

            def swap(a, b):
                os.replace(a, b)
        """,
    }, select=("CB301",)) == []
    # ops inside CB109's own path scope are CB109's findings, not a
    # second CB301 on the same line
    assert run_tree(tmp_path, {
        "file/slab.py": """
            import os

            class SlabStore:
                def append(self, a, b):
                    os.replace(a, b)
        """,
    }, select=("CB301",)) == []


def test_fsio_escape_write_mode_open_and_suppression(tmp_path):
    files = {
        "file/slab.py": """
            from utils import misc

            class SlabStore:
                def compact(self, p):
                    misc.dump(p)
                    misc.load(p)
        """,
        "utils/misc.py": """
            def dump(p):
                with open(p, "wb") as f:
                    f.write(b"x")

            def load(p):
                with open(p, "rb") as f:
                    return f.read()
        """,
    }
    vs = run_tree(tmp_path, files, select=("CB301",))
    # write-mode open flagged, read-mode open not
    assert [v.rule for v in vs] == ["CB301"]
    assert "write-mode open" in vs[0].message
    files["utils/misc.py"] = """
        def dump(p):
            # lint: fsio-escape-ok fixture-sanctioned off-seam write
            with open(p, "wb") as f:
                f.write(b"x")

        def load(p):
            with open(p, "rb") as f:
                return f.read()
    """
    assert run_tree(tmp_path / "sup", files, select=("CB301",)) == []


# -- CB302 clock-escape --

def test_clock_escape_flags_reachable_wall_clock(tmp_path):
    vs = run_tree(tmp_path, {
        "sim/scenario.py": """
            from parallel import util

            async def drive(env):
                return util.step()
        """,
        "parallel/util.py": """
            import time

            def step():
                return time.monotonic()
        """,
    }, select=("CB302",))
    assert [(v.rule, v.path) for v in vs] == \
        [("CB302", "parallel/util.py")]
    assert "time.monotonic()" in vs[0].message
    assert "virtual-time" in vs[0].message


def test_clock_escape_passes_unreachable_and_governed(tmp_path):
    # wall clock in a function no scenario reaches: not this rule's
    # business (and outside CB108's path scope, nobody else's either)
    assert run_tree(tmp_path, {
        "sim/scenario.py": """
            async def drive(env):
                return None
        """,
        "parallel/util.py": """
            import time

            def step():
                return time.monotonic()
        """,
    }, select=("CB302",)) == []
    # reachable wall clock inside CB108's path scope: CB108's finding,
    # never a double report
    assert run_tree(tmp_path, {
        "sim/scenario.py": """
            from cluster import util

            async def drive(env):
                return util.step()
        """,
        "cluster/util.py": """
            import time

            def step():
                return time.monotonic()
        """,
    }, select=("CB302",)) == []


def test_clock_escape_flags_loop_time_and_alias_imports(tmp_path):
    vs = run_tree(tmp_path, {
        "sim/scenario.py": """
            from parallel import util

            async def drive(loop):
                return util.lag(loop) + util.stamp()
        """,
        "parallel/util.py": """
            from time import monotonic as mono

            def lag(loop):
                return loop.time()

            def stamp():
                return mono()
        """,
    }, select=("CB302",))
    assert sorted(v.message.split(" in ")[0] for v in vs) == \
        ["direct loop.time() (loop.time)", "direct time.monotonic"]


# -- CB303 cancel-safety --

def test_cancel_safety_flags_swallowed_cancelled(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        import asyncio

        async def run(q):
            try:
                return await q.get()
            except asyncio.CancelledError:
                return None
    """, select=("CB303",))
    assert [v.rule for v in vs] == ["CB303"]
    assert "swallows CancelledError" in vs[0].message


def test_cancel_safety_flags_bare_and_base_exception(tmp_path):
    vs = run_snippet(tmp_path, "file/x.py", """
        import asyncio

        async def a(q):
            try:
                return await q.get()
            except BaseException:
                return None

        async def b(q):
            try:
                return await q.get()
            except:
                return None
    """, select=("CB303",))
    assert len(vs) == 2
    assert "bare except" in vs[1].message


def test_cancel_safety_passes_reraise_and_child_reap(tmp_path):
    assert run_snippet(tmp_path, "file/x.py", """
        import asyncio

        async def run(q):
            try:
                return await q.get()
            except asyncio.CancelledError:
                raise

        async def stop(task):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    """, select=("CB303",)) == []


def test_cancel_safety_flags_cancel_without_await(tmp_path):
    vs = run_snippet(tmp_path, "gateway/x.py", """
        import asyncio

        async def abort(task):
            task.cancel()
            return True
    """, select=("CB303",))
    assert [v.rule for v in vs] == ["CB303"]
    assert "never awaited" in vs[0].message


def test_cancel_safety_herd_shape_regression(tmp_path):
    """The sim/scenario.py thundering-herd bug class: a finally that
    cancels the reader fleet but never awaits it leaves tasks
    mid-teardown when the function moves on.  Must-flag as written,
    must-pass once the reap gather is added (the shipped fix)."""
    vs = run_snippet(tmp_path, "sim/x.py", """
        import asyncio

        async def herd(make):
            tasks = [asyncio.ensure_future(make()) for _ in range(3)]
            try:
                await asyncio.gather(*tasks)
            finally:
                for t in tasks:
                    t.cancel()
    """, select=("CB303",))
    assert [v.rule for v in vs] == ["CB303"]
    assert run_snippet(tmp_path / "fixed", "sim/x.py", """
        import asyncio

        async def herd(make):
            tasks = [asyncio.ensure_future(make()) for _ in range(3)]
            try:
                await asyncio.gather(*tasks)
            finally:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
    """, select=("CB303",)) == []


def test_cancel_safety_passes_tuple_target_and_handles(tmp_path):
    """The fetch_hedged shape: cancel inside `for task, meta in
    d.items():` is observed by gathering the dict; TimerHandle.cancel()
    completes synchronously and needs no await."""
    assert run_snippet(tmp_path, "file/x.py", """
        import asyncio

        async def reap(pending):
            for task, (loc, t0) in pending.items():
                task.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

        async def disarm(handle):
            handle.cancel()
    """, select=("CB303",)) == []


def test_cancel_safety_flags_publish_window_await(tmp_path):
    vs = run_snippet(tmp_path, "cluster/x.py", """
        import os

        async def publish(f, audit, tmp, dst):
            await f.write(b"x")
            await audit.notify()
            os.replace(tmp, dst)
    """, select=("CB303",))
    assert [v.rule for v in vs] == ["CB303"]
    assert "strands the temp file" in vs[0].message


def test_cancel_safety_passes_shielded_and_tight_windows(tmp_path):
    assert run_snippet(tmp_path, "cluster/x.py", """
        import asyncio
        import os

        async def publish(f, audit, tmp, dst):
            await f.write(b"x")
            await asyncio.shield(audit.notify())
            os.replace(tmp, dst)

        async def publish_tight(f, tmp, dst):
            await f.write(b"x")
            os.replace(tmp, dst)
    """, select=("CB303",)) == []


# -- CB304 sim-purity --

def test_sim_purity_flags_production_imports(tmp_path):
    for src in (
        "from chunky_bits_tpu_torch.sim import fabric\n",
        "import chunky_bits_tpu_torch.sim.fabric\n",
        "from chunky_bits_tpu_torch import sim\n",
        # lazy in-function import: invisible to the runtime pin until
        # the branch executes, still a static finding here
        "def f():\n    from chunky_bits_tpu_torch.sim import loop\n"
        "    return loop\n",
    ):
        vs = run_snippet(tmp_path / str(abs(hash(src)) % 997),
                         "file/x.py", src, select=("CB304",))
        assert [v.rule for v in vs] == ["CB304"], src
        assert "inverts the sim seam" in vs[0].message


def test_sim_purity_passes_sim_plane_and_lookalikes(tmp_path):
    # the simulator importing itself is the point, not a violation
    assert run_snippet(tmp_path, "sim/x.py", """
        from chunky_bits_tpu_torch.sim import fabric
    """, select=("CB304",)) == []
    # 'sim' must match as a dotted segment, not a substring
    assert run_snippet(tmp_path / "b", "file/x.py", """
        import simpy
        from simulation import engine
    """, select=("CB304",)) == []


def test_sim_purity_suppression_on_sanctioned_inversion(tmp_path):
    assert run_snippet(tmp_path, "file/x.py", """
        def resolve(target):
            # lint: sim-purity-ok fixture-sanctioned lazy sim branch
            from chunky_bits_tpu_torch.sim import fabric
            return fabric.resolve(target)
    """, select=("CB304",)) == []


# -- CB305 label-flow --

def test_label_flow_flags_fstring_at_call_site(tmp_path):
    vs = run_snippet(tmp_path, "obs/x.py", """
        COUNTER = object()

        def record(kind):
            COUNTER.labels(kind)

        def handler(path):
            record(f"get:{path}")
    """, select=("CB305",))
    assert [v.rule for v in vs] == ["CB305"]
    assert "'kind'" in vs[0].message
    # the finding lands at the CALL SITE, where the clamp belongs
    assert "record(" in vs[0].snippet


def test_label_flow_passes_closed_args_and_flags_kwargs(tmp_path):
    assert run_snippet(tmp_path, "obs/x.py", """
        COUNTER = object()

        def record(kind):
            COUNTER.labels(kind)

        def handler():
            record("get")
    """, select=("CB305",)) == []
    vs = run_snippet(tmp_path / "kw", "obs/x.py", """
        COUNTER = object()

        class Rec:
            def record(self, kind):
                COUNTER.labels(kind)

        def handler(rec, path):
            rec.record(kind="get:" + path)
    """, select=("CB305",))
    assert [v.rule for v in vs] == ["CB305"]


# -- call-graph precision units --

def _graph(tmp_path: Path, files: dict):
    """The port's call graph of a fixture tree, after checking that the
    reference builds the same one (functions, edges, worker roots)."""
    from chunky_bits_tpu.analysis import callgraph as ref_callgraph
    from chunky_bits_tpu_torch.analysis import callgraph

    sfs, ref_sfs = [], []
    for rel, source in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        src = textwrap.dedent(source)
        path.write_text(src, encoding="utf-8")
        sfs.append(core.SourceFile(path, rel, src))
        ref_sfs.append(ref_core.SourceFile(path, rel, src))
    graph = callgraph.build_call_graph(sfs)
    ref_graph = ref_callgraph.build_call_graph(ref_sfs)
    assert graph.stats() == ref_graph.stats()
    assert set(graph.functions) == set(ref_graph.functions)
    assert {k: sorted(v) for k, v in graph.edges.items()} == \
        {k: sorted(v) for k, v in ref_graph.edges.items()}
    assert graph.roots == ref_graph.roots
    assert graph.unknown_edges == ref_graph.unknown_edges
    return graph


def test_callgraph_self_methods_and_decorators(tmp_path):
    g = _graph(tmp_path, {"x.py": """
        def deco(fn):
            def wrapper():
                return fn()
            return wrapper

        class C:
            @deco
            def a(self):
                self.b()

            def b(self):
                pass
    """})
    assert ("x.py", "C.b") in g.edges[("x.py", "C.a")]
    # calling the decorated method actually runs the decorator's
    # machinery: the decorator is linked to its decoratee
    assert ("x.py", "C.a") in g.edges[("x.py", "deco")]


def test_callgraph_partial_lambda_and_to_thread_roots(tmp_path):
    g = _graph(tmp_path, {"x.py": """
        import asyncio
        import functools

        def helper(n):
            return n

        def lam_helper():
            return helper(2)

        async def spawn():
            await asyncio.to_thread(functools.partial(helper, 1))
            await asyncio.to_thread(lambda: lam_helper())
    """})
    assert ("x.py", "helper") in g.roots
    reach = g.worker_reachable()
    # the lambda is itself a root and its body's calls are followed
    assert ("x.py", "lam_helper") in reach
    assert ("x.py", "helper") in reach


def test_callgraph_counts_unknown_edges_for_dynamic_dispatch(tmp_path):
    g = _graph(tmp_path, {"x.py": """
        def f(cb, table):
            cb()
            table["k"]()
            return f()()
    """})
    assert g.unknown_edges[("x.py", "f")] == 3


def test_callgraph_cross_module_import_resolution(tmp_path):
    g = _graph(tmp_path, {
        "a/one.py": """
            from b import two

            def caller():
                two.target()
        """,
        "b/two.py": """
            def target():
                pass
        """,
    })
    assert ("b/two.py", "target") in g.edges[("a/one.py", "caller")]


def test_callgraph_async_defs_never_run_on_workers(tmp_path):
    """An async def handed to a thread only builds a coroutine object
    there — it must neither seed the worker closure nor be entered by
    it (the FilePart.read false-positive class)."""
    g = _graph(tmp_path, {"x.py": """
        import asyncio

        async def aread():
            return touched()

        def touched():
            return 1

        def sync_root():
            asyncio.to_thread(aread)

        async def spawn():
            await asyncio.to_thread(sync_root)
    """})
    assert ("x.py", "aread") not in g.roots
    reach = g.worker_reachable()
    assert ("x.py", "sync_root") in reach
    assert ("x.py", "aread") not in reach
    assert ("x.py", "touched") not in reach
    # general reachability still follows the handoff: the body DOES run
    # (on a loop), so seam rules must keep seeing it
    assert ("x.py", "aread") in g.reachable({("x.py", "sync_root")})


def test_callgraph_threadsafe_crossing_stops_worker_closure(tmp_path):
    """The HostPipeline bridge/resolve shape: a callable handed back
    through call_soon_threadsafe runs ON the loop — worker-ness must
    not flow through the sanctioned crossing, while plain reachability
    still does."""
    g = _graph(tmp_path, {"x.py": """
        import threading

        def start(loop, fut):
            def bridge():
                def resolve():
                    fut.set_result(1)
                loop.call_soon_threadsafe(resolve)
            threading.Thread(target=bridge, daemon=True).start()
    """})
    key_bridge = ("x.py", "start.bridge")
    key_resolve = ("x.py", "start.bridge.resolve")
    assert key_bridge in g.roots
    assert (key_bridge, key_resolve) in g.loop_edges
    reach = g.worker_reachable()
    assert key_bridge in reach
    assert key_resolve not in reach
    assert key_resolve in g.reachable({key_bridge})


# -- scoped fingerprints + baseline migration --

def test_fingerprint_survives_duplicate_line_churn(tmp_path):
    """The same offending line added in ANOTHER function must not shift
    the first finding's fingerprint (the failure mode of file-wide
    occurrence counting)."""
    before = run_snippet(tmp_path, "ops/x.py", """
        import os

        def f():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")
    """, select=("CB102",))
    after = run_snippet(tmp_path / "b", "ops/x.py", """
        import os

        def earlier():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")

        def f():
            return os.environ.get("CHUNKY_BITS_TORCH_FOO")
    """, select=("CB102",))
    assert len(before) == 1 and len(after) == 2
    f_after = [v for v in after if v.scope == "f"]
    assert [v.fingerprint for v in f_after] == \
        [before[0].fingerprint]


def test_baseline_legacy_fingerprints_still_match(tmp_path):
    """One-shot migration: a pre-scope baseline entry (written before
    fingerprints carried the enclosing qualname) keeps matching through
    Violation.keys() until the next --write-baseline rewrites it."""
    vs = _sample_violations(tmp_path)
    legacy_entries = "".join(
        f'[[violation]]\nrule = "{v.rule}"\npath = "{v.path}"\n'
        f'fingerprint = "{v.legacy_fingerprint}"\n'
        for v in vs)
    baseline_path = tmp_path / "legacy.toml"
    baseline_path.write_text(legacy_entries, encoding="utf-8")
    accepted = core.load_baseline(baseline_path)
    assert all(set(v.keys()) & accepted for v in vs)
    # and the scoped spelling differs, so the dual key is load-bearing
    assert all(v.key() not in accepted for v in vs)


def test_write_baseline_records_scope(tmp_path):
    vs = _sample_violations(tmp_path)
    baseline_path = tmp_path / "b.toml"
    core.write_baseline(baseline_path, vs)
    text = baseline_path.read_text(encoding="utf-8")
    assert 'scope = "f"' in text and 'scope = "g"' in text


# -- CLI: --explain / --format github / --graph-stats --

def test_cli_explain_rule_and_family():
    proc = _run_cli("--explain", "CB303")
    assert proc.returncode == 0
    assert "cancel-safety" in proc.stdout
    assert "child-reap" in proc.stdout  # the docstring, not one line
    proc = _run_cli("--explain", "CB3")
    assert proc.returncode == 0
    for rid in ("CB301", "CB302", "CB303", "CB304", "CB305"):
        assert rid in proc.stdout
    proc = _run_cli("--explain", "fsio-escape")
    assert proc.returncode == 0 and "CB301" in proc.stdout
    proc = _run_cli("--explain", "CB999")
    assert proc.returncode == 2


def test_cli_format_github_annotations(tmp_path):
    scratch = tmp_path / "pkg"
    (scratch / "file").mkdir(parents=True)
    (scratch / "file" / "x.py").write_text(
        "import asyncio\n\n\nasync def run(q):\n    try:\n"
        "        return await q.get()\n"
        "    except asyncio.CancelledError:\n        return None\n",
        encoding="utf-8")
    proc = _run_cli("--root", str(scratch), "--no-baseline",
                    "--format", "github")
    assert proc.returncode == 1
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("::error")][0]
    assert "file=file/x.py" in line
    assert "title=CB303 [cancel-safety]" in line
    # messages are single annotation lines whatever they contain
    assert "\n" not in line and "%0A" not in line.split("::")[0]


def test_cli_graph_stats_text_and_json():
    proc, _ = _shipped("--select", "CB3", "--graph-stats")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graph:" in proc.stdout and "worker roots" in proc.stdout
    payload = _shipped_json()["payload"]
    assert payload["graph"]["functions"] > 1000
    assert payload["graph"]["edges"] > payload["graph"]["functions"]
    assert 0 < payload["graph"]["worker_roots"] < 200


def test_cli_select_cb3_exits_zero_on_shipped_tree():
    """The reachability family alone, inside its 15 s budget (CPU
    seconds of the run: the box's other load does not count)."""
    proc, elapsed = _shipped("--select", "CB3", "--graph-stats")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert elapsed < 15.0, f"--select CB3 took {elapsed:.1f}s"


def test_analyzer_imports_no_heavy_deps():
    """The linter must run on a box with no card: a full in-process
    analysis may not drag in torch/jax/numpy/aiohttp."""
    run = _shipped_json()
    assert run["rc"] == 0
    assert run["heavy"] == [], run["heavy"]


def test_analyzer_runtime_budget():
    """Full run (all families, graph build included) stays under the
    CI budget — the whole-program pass must not make the gate the slow
    leg.  The budget is in CPU seconds of the run, so that a loaded box
    (the suite's other workers) cannot fail it."""
    proc, elapsed = _shipped("--graph-stats")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert elapsed < 15.0, f"analysis took {elapsed:.1f}s"
    assert _shipped_json()["seconds"] < 15.0


# ---- CB4xx resource-lifetime & deadline-propagation family ----

def _cfg_of(source: str):
    """Build the CFG of the first function in ``source``."""
    import ast

    from chunky_bits_tpu.analysis import cfg as ref_cfgmod
    from chunky_bits_tpu_torch.analysis import cfg as cfgmod

    fn = ast.parse(textwrap.dedent(source)).body[0]
    built = cfgmod.build_cfg(fn)
    ref = ref_cfgmod.build_cfg(fn)
    assert built.kinds == ref.kinds
    assert (built.flow, built.exc) == (ref.flow, ref.exc)
    return built


def _kinds(cfg) -> list:
    return cfg.kinds


def test_cfg_try_finally_edges():
    """Every way out of the try (fall-through, body exception, handler
    exception) runs the finally, and the finally's exits propagate the
    exceptional continuation outward."""
    from chunky_bits_tpu_torch.analysis import cfg as cfgmod

    cfg = _cfg_of("""
        def f(a):
            try:
                a.work()
            finally:
                a.cleanup()
            return a
    """)
    assert cfgmod.K_FINPAD in cfg.kinds
    pad = cfg.kinds.index(cfgmod.K_FINPAD)
    import ast as _ast
    work = next(i for i, s in enumerate(cfg.stmts)
                if s is not None and isinstance(s, _ast.Expr)
                and "work" in _ast.dump(s))
    cleanup = next(i for i, s in enumerate(cfg.stmts)
                   if s is not None and isinstance(s, _ast.Expr)
                   and "cleanup" in _ast.dump(s))
    # body exception lands on the finally pad, not the raise exit
    assert cfg.exc[work] == {pad}
    assert pad in cfg.flow[work]  # fall-through also runs the finally
    assert cleanup in cfg.flow[pad]
    # the finally may be completing an exceptional path: its exit
    # nodes carry an exc edge outward
    assert cfg.raise_exit in cfg.exc[cleanup]


def test_cfg_with_unwind_and_await_cancellation_edges():
    """A with-body statement's exception unwinds through __exit__ (its
    exc edge), and EVERY await carries an exc edge — cancellation can
    surface at any suspension point even with nothing else to fail."""
    import ast as _ast

    cfg = _cfg_of("""
        async def f(cm, t):
            with cm:
                await t
    """)
    aw = next(i for i, s in enumerate(cfg.stmts)
              if s is not None and isinstance(s, _ast.Expr))
    assert cfg.raise_exit in cfg.exc[aw]
    # a bare await of a plain name: no call anywhere, still an exc
    # edge (the await-as-cancellation-point rule)
    cfg2 = _cfg_of("""
        async def g(t):
            await t
    """)
    aw2 = next(i for i, s in enumerate(cfg2.stmts)
               if s is not None and isinstance(s, _ast.Expr))
    assert cfg2.raise_exit in cfg2.exc[aw2]


def test_cfg_loop_orelse_break_continue():
    """break exits past the orelse, continue returns to the header,
    orelse runs only on normal loop exhaustion."""
    import ast as _ast

    cfg = _cfg_of("""
        def f(xs):
            for x in xs:
                if x:
                    break
                continue
            else:
                tail()
            return 1
    """)
    header = next(i for i, s in enumerate(cfg.stmts)
                  if isinstance(s, _ast.For))
    brk = next(i for i, s in enumerate(cfg.stmts)
               if isinstance(s, _ast.Break))
    cont = next(i for i, s in enumerate(cfg.stmts)
                if isinstance(s, _ast.Continue))
    ret = next(i for i, s in enumerate(cfg.stmts)
               if isinstance(s, _ast.Return))
    orelse = next(i for i, s in enumerate(cfg.stmts)
                  if s is not None and isinstance(s, _ast.Expr)
                  and "tail" in _ast.dump(s))
    assert cfg.flow[cont] == {header}
    assert ret in cfg.flow[brk]        # break skips the orelse
    assert orelse not in cfg.flow[brk]
    assert orelse in cfg.flow[header]  # exhaustion runs the orelse
    assert ret in cfg.flow[orelse]


def test_cfg_while_true_only_exits_via_break():
    cfg = _cfg_of("""
        def f(q):
            while True:
                if q.done():
                    break
        """)
    import ast as _ast
    brk = next(i for i, s in enumerate(cfg.stmts)
               if isinstance(s, _ast.Break))
    header = next(i for i, s in enumerate(cfg.stmts)
                  if isinstance(s, _ast.While))
    # the header has no normal exit edge to the function exit — only
    # the break reaches it
    assert cfg.exit not in cfg.flow[header]
    assert cfg.exit in cfg.flow[brk]


def test_cfg_dataflow_may_vs_must():
    """The engine's two meets on one diamond: a fact genned on one
    branch MAY reach the join but is not a MUST there."""
    import ast as _ast

    from chunky_bits_tpu_torch.analysis.cfg import dataflow

    cfg = _cfg_of("""
        def f(c):
            if c:
                x = acquire()
            return x
    """)
    acq = next(i for i, s in enumerate(cfg.stmts)
               if isinstance(s, _ast.Assign))
    ret = next(i for i, s in enumerate(cfg.stmts)
               if isinstance(s, _ast.Return))
    gen = [frozenset()] * cfg.n_nodes
    kill = [frozenset()] * cfg.n_nodes
    gen[acq] = frozenset({"x"})
    may = dataflow(cfg, gen, kill)
    must = dataflow(cfg, gen, kill, must=True)
    assert "x" in may[ret]
    assert must[ret] is not None and "x" not in must[ret]


# -- CB401 fd-leak --

def test_fd_leak_flags_unguarded_open(tmp_path):
    """The reference's to_thread(open) leak shape: a statement between open and the custody
    transfer can raise (or the await can be cancelled), orphaning f."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            def f(path, n):
                f = open(path, "rb")
                f.seek(n)
                return f
        """,
    }, select=("CB401",))
    assert [v.rule for v in vs] == ["CB401"]
    assert "exception/cancellation path" in vs[0].message
    assert "f = open()" in vs[0].message


def test_fd_leak_passes_opener_guard_and_with(tmp_path):
    """The two sanctioned shapes: the try/except-BaseException opener
    guard (utils/aio.py FileReader._ensure) and plain `with`."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            def guarded(path, n):
                f = open(path, "rb")
                try:
                    f.seek(n)
                except BaseException:
                    f.close()
                    raise
                return f

            def scoped(path):
                with open(path, "rb") as f:
                    return f.read()
        """,
    }, select=("CB401",))
    assert vs == []


def test_fd_leak_negative_control_open_in_thread_reaper(tmp_path):
    """The exact aio.open_in_thread opener contract, both ways: with
    the reaper guard the opener is clean; DELETE the guard and CB401
    must catch the orphaned handle on the cancellation path — proving
    the rule catches the reference's to_thread(open) leak."""
    guarded = """
        def _open(path, off):
            f = open(path, "rb")
            try:
                if off:
                    f.seek(off)
            except BaseException:
                f.close()
                raise
            return f
    """
    reaper_deleted = """
        def _open(path, off):
            f = open(path, "rb")
            if off:
                f.seek(off)
            return f
    """
    assert run_tree(tmp_path, {"utils/a.py": guarded},
                    select=("CB401",)) == []
    vs = run_tree(tmp_path, {"utils/b.py": reaper_deleted},
                  select=("CB401",))
    assert [v.rule for v in vs] == ["CB401"]


def test_fd_leak_custody_transfers_pass(tmp_path):
    """Handing the handle to a callee, storing it through an attribute
    or into a container (even inside a tuple), yielding it — all
    custody transfers, not leaks."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            def to_callee(path, sink):
                f = open(path, "rb")
                sink(f)

            class Holder:
                def stash(self, path):
                    f = open(path, "rb")
                    self._f = f

                def index(self, path, k):
                    f = open(path, "rb")
                    self._m[k] = (path, f)

            def gen(path):
                f = open(path, "rb")
                yield f
        """,
    }, select=("CB401",))
    assert vs == []


def test_fd_leak_socket_mmap_and_fsio_open_tracked(tmp_path):
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            import socket
            import mmap

            def s():
                sock = socket.socket()
                sock.connect(("h", 1))
                return sock

            def m(f):
                mm = mmap.mmap(f.fileno(), 0)
                if mm.size() == 0:
                    return None
                return mm
        """,
    }, select=("CB401",))
    assert sorted(v.message.split(" = ")[0].split()[-1] for v in vs) \
        == ["mm", "sock"]


def test_fd_leak_close_methods_exempt(tmp_path):
    """close()/__exit__ implementations ARE the release — the split
    halves must not self-flag."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            class R:
                def close(self):
                    f = open(self._path, "rb")
                    f.flush()
        """,
    }, select=("CB401",))
    assert vs == []


# -- CB402 lock-discipline --

def test_lock_discipline_flags_unpaired_acquire(tmp_path):
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            def f(lock, work):
                lock.acquire()
                work()
                lock.release()
        """,
    }, select=("CB402",))
    assert [v.rule for v in vs] == ["CB402"]
    assert "deadlock" in vs[0].message
    assert "with lock:" in vs[0].message


def test_lock_discipline_passes_finally_and_with(tmp_path):
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            def paired(lock, work):
                lock.acquire()
                try:
                    work()
                finally:
                    lock.release()

            def ctx(lock, work):
                with lock:
                    work()
        """,
    }, select=("CB402",))
    assert vs == []


def test_lock_discipline_flock_pairing(tmp_path):
    """fcntl.flock: LOCK_EX without LOCK_UN on the exception path
    flags; the finally-paired shape passes (file/slab.py _Flock's
    split across __enter__/__exit__ is exempt by function name)."""
    flagged = run_tree(tmp_path, {
        "utils/u.py": """
            import fcntl

            def f(fd, work):
                fcntl.flock(fd, fcntl.LOCK_EX)
                work()
                fcntl.flock(fd, fcntl.LOCK_UN)
        """,
    }, select=("CB402",))
    assert [v.rule for v in flagged] == ["CB402"]
    clean = run_tree(tmp_path / "b", {
        "utils/u.py": """
            import fcntl

            def f(fd, work):
                fcntl.flock(fd, fcntl.LOCK_EX)
                try:
                    work()
                finally:
                    fcntl.flock(fd, fcntl.LOCK_UN)

            class _Flock:
                def __enter__(self):
                    fcntl.flock(self._fd, fcntl.LOCK_EX)

                def __exit__(self, *exc):
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
        """,
    }, select=("CB402",))
    assert clean == []


# -- CB403 task-custody --

def test_task_custody_flags_assigned_then_leaked(tmp_path):
    """The shape syntactic CB203 cannot see: the task IS assigned, but
    an intervening cancellation point exits the scope without it."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            import asyncio

            async def f(work, other):
                t = asyncio.create_task(work())
                await other()
                await t
        """,
    }, select=("CB403",))
    assert [v.rule for v in vs] == ["CB403"]
    assert "exception/cancellation path" in vs[0].message


def test_task_custody_passes_owned_shapes(tmp_path):
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            import asyncio

            async def reaped(work, other):
                t = asyncio.create_task(work())
                try:
                    await other()
                finally:
                    t.cancel()
                    await t

            async def gathered(work):
                t = asyncio.ensure_future(work())
                await asyncio.gather(t)

            class S:
                def stored(self, work):
                    t = asyncio.create_task(work())
                    self._tasks.add(t)

            async def callbacked(work, reap):
                t = asyncio.ensure_future(work())
                t.add_done_callback(reap)
        """,
    }, select=("CB403",))
    assert vs == []


def test_task_custody_cancel_alone_is_not_custody(tmp_path):
    """cancel() only requests — without an await nothing observes the
    outcome (CB303's point, made path-sensitive)."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            import asyncio

            async def f(work):
                t = asyncio.create_task(work())
                t.cancel()
        """,
    }, select=("CB403",))
    assert [v.rule for v in vs] == ["CB403"]


# -- CB404 unbounded-deadline --

def test_unbounded_deadline_flags_cross_module_bare_await(tmp_path):
    """The gap CB101's path list leaves: a bare await in a module off
    the list, reached from a gateway handler."""
    vs = run_tree(tmp_path, {
        "gateway/http.py": """
            from cluster import cluster

            async def handle(req):
                await cluster.fetch(req)
        """,
        "cluster/cluster.py": """
            async def fetch(req):
                await req.wait()
        """,
    }, select=("CB404",))
    assert [(v.rule, v.path) for v in vs] == \
        [("CB404", "cluster/cluster.py")]
    assert "no deadline at ANY frame" in vs[0].message


def test_unbounded_deadline_passes_bound_at_caller(tmp_path):
    """The converse gap: wait_for at the CALL SITE bounds everything
    beneath — the callee's bare await is fine on that path."""
    vs = run_tree(tmp_path, {
        "gateway/http.py": """
            import asyncio

            from cluster import cluster

            async def handle(req):
                await asyncio.wait_for(cluster.fetch(req), 5.0)
        """,
        "cluster/cluster.py": """
            async def fetch(req):
                await req.wait()
        """,
    }, select=("CB404",))
    assert vs == []


def test_unbounded_deadline_unreachable_and_governed_pass(tmp_path):
    """A bare await nothing serving-rooted reaches is CB101's business
    (or nobody's); modules CB101 already governs are excluded."""
    vs = run_tree(tmp_path, {
        "gateway/http.py": """
            async def handle(req):
                return req
        """,
        "cluster/cluster.py": """
            async def orphan(req):
                await req.wait()
        """,
        "ops/pipeline_helper.py": """
            async def governed(evt):
                await evt
        """,
    }, select=("CB404",))
    assert vs == []


# -- CB405 metered-io --

def test_metered_io_flags_uncharged_read(tmp_path):
    vs = run_tree(tmp_path, {
        "cluster/scrub.py": """
            class ScrubDaemon:
                async def run(self, loc):
                    await self._verify(loc)

                async def _verify(self, loc):
                    data = await loc.read()
        """,
    }, select=("CB405",))
    assert [(v.rule, v.path) for v in vs] == \
        [("CB405", "cluster/scrub.py")]
    assert "bucket.take()" in vs[0].message


def test_metered_io_passes_local_and_caller_charge(tmp_path):
    """Charge at the site passes; so does the charge-in-the-caller
    shape (entered-metered summaries composed through the graph)."""
    vs = run_tree(tmp_path, {
        "cluster/scrub.py": """
            class ScrubDaemon:
                async def run(self, loc):
                    await self._bucket.take(8)
                    data = await loc.read()
                    await self.bucket.take(8)
                    await self._helper(loc)

                async def _helper(self, loc):
                    return await loc.read()
        """,
    }, select=("CB405",))
    assert vs == []


def test_metered_io_one_charge_covers_one_io(tmp_path):
    """Exact metering: take once, read twice — the second read is
    uncharged and must flag."""
    vs = run_tree(tmp_path, {
        "cluster/repair.py": """
            async def repair_part(bucket, a, b):
                await bucket.take(8)
                x = await a.read()
                y = await b.read()
        """,
    }, select=("CB405",))
    assert len(vs) == 1
    assert vs[0].line == max(v.line for v in vs)  # the second read


def test_metered_io_metadata_plane_exempt(tmp_path):
    vs = run_tree(tmp_path, {
        "cluster/scrub.py": """
            class ScrubDaemon:
                async def run(self):
                    refs = await self.metadata.read("ns")
        """,
    }, select=("CB405",))
    assert vs == []


# -- family wiring --

def test_cb4_suppression_and_family_select(tmp_path):
    """Inline suppression works for CFG-rule findings, and --select CB4
    runs the family alone."""
    vs = run_tree(tmp_path, {
        "utils/u.py": """
            def f(path, n):
                # lint: fd-leak-ok handed to the caller's reaper registry
                f = open(path, "rb")
                f.seek(n)
                return f
        """,
    }, select=("CB401",))
    assert vs == []
    proc = _run_cli("--select", "CB4", "--list-rules")
    assert proc.returncode == 0
    for rid in ("CB401", "CB402", "CB403", "CB404", "CB405"):
        assert rid in proc.stdout
    assert "CB101" not in proc.stdout


def test_cb4_shipped_tree_clean_and_graph_stats_grow_cfg():
    """The family's acceptance criterion: --select CB4 exits 0 on the
    shipped tree inside its 15 s budget (CPU seconds), and --graph-stats
    reports the CFG layer's totals in both text and JSON."""
    proc, elapsed = _shipped("--select", "CB4", "--graph-stats", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert elapsed < 15.0, f"--select CB4 took {elapsed:.1f}s"
    payload = json.loads(proc.stdout)
    graph = payload["graph"]
    for key in ("cfg_functions", "cfg_blocks", "cfg_edges",
                "dataflow_summaries"):
        assert graph[key] > 0, (key, graph)
    proc, _ = _shipped("--graph-stats")
    assert proc.returncode == 0
    assert "cfg:" in proc.stdout and "summaries" in proc.stdout


def test_cli_prune_baseline_drops_stale_entries(tmp_path):
    """A deleted violation must not leave a dangling accept: prune
    rewrites the baseline keeping only entries that still match."""
    scratch = tmp_path / "pkg"
    (scratch / "ops").mkdir(parents=True)
    bad = ("import os\n\n\ndef f():\n"
           "    return os.environ.get('CHUNKY_BITS_TORCH_KNOB')\n")
    (scratch / "ops" / "m.py").write_text(bad, encoding="utf-8")
    base = tmp_path / "b.toml"
    proc = _run_cli("--root", str(scratch), "--baseline", str(base),
                    "--write-baseline")
    assert proc.returncode == 0
    assert core.load_baseline(base)
    # fix the violation, then prune: the stale accept must vanish
    (scratch / "ops" / "m.py").write_text(
        "def f():\n    return None\n", encoding="utf-8")
    proc = _run_cli("--root", str(scratch), "--baseline", str(base),
                    "--prune-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dropped 1" in proc.stdout
    assert core.load_baseline(base) == set()
    # and the guards mirror --write-baseline: no partial-scan prunes
    proc = _run_cli("--root", str(scratch), "--baseline", str(base),
                    "--select", "CB101", "--prune-baseline")
    assert proc.returncode == 2
    assert "full scan" in proc.stderr


def test_shipped_baseline_has_no_stale_entries():
    """CI fails on dangling accepts; this is the same check in-tree."""
    run = _shipped_json()
    assert run["rc"] == 0
    assert run["payload"]["stale_baseline_entries"] == 0


# ---- the whole trees, both linters ----

def test_port_linter_on_port_tree_reports_nothing():
    """The port's linter over chunky_bits_tpu_torch/ against its own
    baseline: 0 new, 0 baselined, 0 stale, and the baseline holds no
    entry at all (every finding is repaired or justified inline)."""
    payload = _shipped_json()["payload"]
    assert payload["new"] == [] and payload["errors"] == []
    assert payload["baselined"] == 0
    assert payload["stale_baseline_entries"] == 0
    assert core.load_baseline(PKG_ROOT / "analysis" / "baseline.toml") \
        == set()


def test_reference_linter_on_port_tree_reports_nothing():
    """The JAX package's linter over the port with no baseline: every
    invariant it holds its own tree to, the port keeps too."""
    t0 = time.process_time()
    violations, errors = ref_core.run_analysis(PKG_ROOT,
                                               ref_rules.ALL_RULES)
    elapsed = time.process_time() - t0
    assert not errors, errors
    assert [v.render() for v in violations] == []
    assert elapsed < 15.0, f"analysis took {elapsed:.1f}s"


def test_port_linter_on_reference_tree_agrees():
    """The port's linter over chunky_bits_tpu/ with the reference's
    baseline reports exactly the reference's own findings for every
    rule but CB102 and CB105, by fingerprint, and the reference's
    accepted entries match nothing else."""
    t0 = time.process_time()
    port, errors = core.run_analysis(REF_ROOT, rules.ALL_RULES)
    elapsed = time.process_time() - t0
    assert not errors, errors
    ref, ref_errors = ref_core.run_analysis(REF_ROOT, ref_rules.ALL_RULES)
    assert not ref_errors, ref_errors
    assert elapsed < 15.0, f"analysis took {elapsed:.1f}s"

    def keyed(vs):
        return {v.key() for v in vs if v.rule not in DIVERGENT}

    assert keyed(port) == keyed(ref)
    baseline = core.load_baseline(REF_ROOT / "analysis" / "baseline.toml")
    new = [v for v in port if v.rule not in DIVERGENT
           and not set(v.keys()) & baseline]
    assert new == [] and _where(port) == _where(ref)
    # the reference's accepted entries are all its jit-hygiene sites
    assert {rule for rule, _path, _fp in baseline} == {"CB105"}
    assert not [v for v in port if v.rule == "CB105"]


@pytest.mark.parametrize(
    "path", sorted((PKG_ROOT / "analysis").glob("*.py")),
    ids=lambda p: p.name)
def test_analysis_modules_import_only_stdlib_and_own_package(path):
    """The linter and the sanitizer run where no card, torch or jax is
    present: each module imports the standard library and its own
    package, nothing else (not even the JAX package's jax-free linter).
    ``tomli`` is core.py's baseline reader on interpreters older than
    3.11, tried only when ``tomllib`` is missing."""
    import ast

    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert (top in sys.stdlib_module_names or top == "tomli"
                    or name.startswith("chunky_bits_tpu_torch.analysis")), \
                (path.name, name)
