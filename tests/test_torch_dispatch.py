"""The port's dispatch window (``ops/dispatch_pipeline.py``) against the JAX
package's: the assertions of ``tests/test_mesh_backend.py`` on the window
(double buffer, depth 0, idempotent results, cancel, poison, the depth env
knob), and one scripted run of submits, results, cancels and failures
through both classes with the same outcome and counters.  Plain callables
only: the window is device-agnostic."""

import dataclasses

import pytest

from chunky_bits_tpu.cluster import tunables as jtunables
from chunky_bits_tpu.ops import dispatch_pipeline as jpipe
from chunky_bits_tpu_torch.cluster import tunables
from chunky_bits_tpu_torch.ops import dispatch_pipeline as tpipe
from chunky_bits_tpu_torch.ops.dispatch_pipeline import (DEFAULT_DEPTH,
                                                         DispatchCancelled,
                                                         DispatchPipeline)


def test_double_buffer_window():
    """depth=2 holds at most two un-materialized dispatches: the third
    submit drains the oldest, FIFO."""
    drained = []
    pipe = DispatchPipeline(depth=2)
    entries = [pipe.submit(lambda i=i: i,
                           lambda h: drained.append(h) or h * 10)
               for i in range(4)]
    assert drained == [0, 1]
    assert pipe.inflight == 2
    assert [pipe.result(e) for e in entries] == [0, 10, 20, 30]
    assert drained == [0, 1, 2, 3]
    st = pipe.stats()
    assert st.submitted == st.completed == 4
    # the peak counts the submit being admitted (depth + 1)
    assert st.max_inflight == 3
    assert st.submits_while_busy == 3
    assert st.cancelled == 0


def test_depth_zero_is_serial():
    pipe = DispatchPipeline(depth=0)
    for i in range(3):
        e = pipe.submit(lambda i=i: i, lambda h: h + 1)
        assert pipe.inflight == 0
        assert pipe.result(e) == i + 1
    st = pipe.stats()
    assert st.max_inflight <= 1
    assert st.submits_while_busy == 0


def test_result_is_idempotent_and_out_of_order():
    pipe = DispatchPipeline(depth=4)
    a = pipe.submit(lambda: "a", lambda h: h)
    b = pipe.submit(lambda: "b", lambda h: h)
    # asking for the younger first drains the older too (FIFO bound)
    assert pipe.result(b) == "b"
    assert pipe.result(a) == "a"
    assert pipe.result(a) == "a"


def test_cancel_drops_without_touching_handles():
    pipe = DispatchPipeline(depth=4)
    touched = []
    e = pipe.submit(lambda: "handle", lambda h: touched.append(h))
    pipe.cancel()
    assert pipe.inflight == 0
    with pytest.raises(DispatchCancelled):
        pipe.result(e)
    assert touched == []
    assert pipe.stats().cancelled == 1


def test_failure_poisons_younger_entries():
    pipe = DispatchPipeline(depth=4)

    def boom(_handle):
        raise RuntimeError("the card failed")

    bad = pipe.submit(lambda: None, boom)
    young = pipe.submit(lambda: None, lambda h: h)
    with pytest.raises(RuntimeError, match="card failed"):
        pipe.result(bad)
    with pytest.raises(DispatchCancelled):
        pipe.result(young)
    st = pipe.stats()
    assert st.cancelled == 1 and st.completed == 0


def test_drain_and_host_overlap():
    pipe = DispatchPipeline(depth=3)
    entries = [pipe.submit(lambda i=i: i, lambda h: -h) for i in range(3)]
    pipe.note_host_overlap(0.25)
    pipe.drain()
    assert pipe.inflight == 0
    assert [pipe.result(e) for e in entries] == [0, -1, -2]
    assert pipe.stats().host_overlap_s == 0.25


def test_depth_env_tunable(monkeypatch):
    monkeypatch.setenv(tunables.DISPATCH_DEPTH_ENV, "3")
    assert DispatchPipeline().depth == 3
    monkeypatch.setenv(tunables.DISPATCH_DEPTH_ENV, "0")
    assert DispatchPipeline().depth == 0
    for bad in ("two", "-1", "1.5"):
        monkeypatch.setenv(tunables.DISPATCH_DEPTH_ENV, bad)
        assert DispatchPipeline().depth == DEFAULT_DEPTH
    monkeypatch.delenv(tunables.DISPATCH_DEPTH_ENV)
    assert DispatchPipeline().depth == DEFAULT_DEPTH
    # the JAX package's variable does not reach the port
    monkeypatch.setenv(jtunables.DISPATCH_DEPTH_ENV, "5")
    assert DispatchPipeline().depth == DEFAULT_DEPTH


@pytest.mark.parametrize("raw", ["", "0", "1", "7", "two", "-1", "1.5",
                                 " 3 "])
def test_depth_parsing_equals_jax(monkeypatch, raw):
    monkeypatch.setenv(tunables.DISPATCH_DEPTH_ENV, raw)
    monkeypatch.setenv(jtunables.DISPATCH_DEPTH_ENV, raw)
    assert tunables.dispatch_depth() == jtunables.dispatch_depth()
    assert DEFAULT_DEPTH == jpipe.DEFAULT_DEPTH


def _script(mod, depth):
    """One run of submits, results, a failure and a cancel through
    ``mod.DispatchPipeline``; returns what happened and the counters."""
    log = []
    pipe = mod.DispatchPipeline(depth=depth)

    def mat(h):
        if h == "bad":
            raise ValueError("bad handle")
        log.append(h)
        return h

    def attempt(fn):
        try:
            return fn()
        except ValueError:
            log.append("failed")
        except mod.DispatchCancelled:
            log.append("cancelled")

    entries = [pipe.submit(lambda i=i: i, mat) for i in range(5)]
    log.append(("inflight", pipe.inflight))
    log.append(("r", pipe.result(entries[3])))
    # at depth 0 and 1 the failure surfaces from the next submit's drain
    bad = attempt(lambda: pipe.submit(lambda: "bad", mat))
    young = attempt(lambda: pipe.submit(lambda: 9, mat))
    for e in (bad, young, entries[4]):
        if e is not None:
            log.append(("r", attempt(lambda: pipe.result(e))))
    tail = pipe.submit(lambda: 10, mat)
    pipe.cancel()
    attempt(lambda: pipe.result(tail))
    stats = dataclasses.asdict(pipe.stats())
    return log, stats


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_scripted_run_equals_jax(depth):
    assert _script(tpipe, depth) == _script(jpipe, depth)
