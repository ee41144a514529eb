"""The port's virtual-time event loop (``chunky_bits_tpu_torch/sim/loop.py``),
held against the JAX package's ``chunky_bits_tpu/sim/loop.py``.

Virtual time jumps straight to the next timer; thread work (the default
executor, ``asyncio.to_thread``, an explicit executor through
``run_in_executor``) completes at zero virtual width; the clock seam reads
the loop's time during the run and the system clock after it; teardown
cancels every task and closes the loop; and one seeded schedule of timers,
sleeps, thread hops and ``call_soon`` callbacks (numpy ``SEED``) gives the
same (virtual time, event) trace under both packages' ``sim.run``.
"""

import asyncio
import concurrent.futures
import threading
import time

import numpy as np
import pytest

from chunky_bits_tpu_torch.sim import VirtualTimeLoop, run
from chunky_bits_tpu_torch.utils import clock

SEED = 20261017


def test_virtual_time_jumps_to_the_next_timer():
    async def main():
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        fired = []
        loop.call_later(7200.0, fired.append, "late")
        await asyncio.sleep(3600.0)
        mid = loop.time()
        await clock.sleep(3600.5)
        return t0, mid, clock.monotonic(), fired

    wall = time.monotonic()
    t0, mid, end, fired = run(main())
    assert time.monotonic() - wall < 5.0
    assert (t0, mid) == (0.0, 3600.0)
    assert end == pytest.approx(7200.5)
    assert fired == ["late"]


def test_thread_work_completes_at_zero_virtual_width():
    async def main():
        loop = asyncio.get_running_loop()
        t0 = clock.monotonic()
        a = await asyncio.to_thread(lambda: time.sleep(0.05) or "a")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            b = await loop.run_in_executor(pool, lambda: time.sleep(0.05)
                                           or "b")
        threads = await asyncio.gather(*(
            asyncio.to_thread(threading.get_ident) for _ in range(4)))
        # a timer armed while a thread is out does not fire early
        timer = asyncio.ensure_future(asyncio.sleep(10.0))
        c = await asyncio.to_thread(lambda: time.sleep(0.05) or "c")
        assert not timer.done()
        await timer
        return (a, b, c), clock.monotonic() - t0, set(threads)

    got, elapsed, threads = run(main())
    assert got == ("a", "b", "c")
    assert elapsed == 10.0
    assert len(threads) == 1  # the loop's one serial worker


def test_clock_seam_follows_the_run():
    before = clock.active()

    async def main():
        assert isinstance(clock.active(), clock.VirtualClock)
        assert isinstance(asyncio.get_running_loop(), VirtualTimeLoop)
        await asyncio.sleep(5)
        return clock.monotonic()

    assert run(main()) == 5.0
    assert clock.active() is before


def test_teardown_leaves_no_task():
    state = {}

    async def forever():
        try:
            await asyncio.sleep(1e9)
        finally:
            state["cleanup_at"] = clock.monotonic()

    async def agen():
        try:
            while True:
                yield 1
        finally:
            state["agen_closed"] = True

    async def main():
        loop = asyncio.get_running_loop()
        state["loop"] = loop
        state["task"] = asyncio.ensure_future(forever())
        gen = agen()
        await gen.__anext__()
        state["gen"] = gen
        await asyncio.sleep(2.0)
        return "done"

    assert run(main()) == "done"
    loop = state["loop"]
    assert loop.is_closed()
    assert state["task"].cancelled()
    # the cancelled task cleaned up on the still-virtual clock
    assert state["cleanup_at"] == 2.0
    assert state["agen_closed"] is True
    assert loop._serial_executor._shutdown
    assert not asyncio.all_tasks(loop)
    with pytest.raises(RuntimeError):
        asyncio.get_running_loop()


def test_run_refuses_a_running_loop():
    async def outer():
        coro = asyncio.sleep(0)
        try:
            with pytest.raises(RuntimeError, match="running event loop"):
                run(coro)
        finally:
            coro.close()

    asyncio.run(outer())


def seeded_schedule(rng, n: int) -> list:
    """``n`` seeded events: (kind, start delay, amount)."""
    kinds = ("sleep", "timer", "thread", "soon")
    return [(kinds[int(rng.integers(0, 4))],
             round(float(rng.exponential(3.0)), 4),
             round(float(rng.exponential(0.5)), 4)) for _ in range(n)]


def trace_of(sim_run, clock_mod, schedule):
    async def main():
        loop = asyncio.get_running_loop()
        trace = []

        def note(tag):
            trace.append((round(clock_mod.monotonic(), 6), tag))

        async def event(i, kind, start, amount):
            await asyncio.sleep(start)
            note(f"{i}:{kind}:start")
            if kind == "sleep":
                await asyncio.sleep(amount)
            elif kind == "timer":
                fut = loop.create_future()
                loop.call_later(amount, fut.set_result, None)
                await fut
            elif kind == "thread":
                await asyncio.to_thread(time.sleep, amount / 100)
            else:
                fut = loop.create_future()
                loop.call_soon(fut.set_result, None)
                await fut
            note(f"{i}:{kind}:end")

        await asyncio.gather(*(event(i, *e) for i, e in enumerate(schedule)))
        return trace

    return sim_run(main())


def test_seeded_schedule_traces_equal_jax():
    from chunky_bits_tpu.sim import run as jax_run
    from chunky_bits_tpu.utils import clock as jax_clock

    schedule = seeded_schedule(np.random.default_rng(SEED), 60)
    ours = trace_of(run, clock, schedule)
    assert ours == trace_of(run, clock, schedule)  # deterministic
    theirs = trace_of(jax_run, jax_clock, schedule)
    assert ours == theirs
    assert len(ours) == 120
    # thread hops took no virtual time
    ends = dict((tag, t) for t, tag in ours)
    for i, (kind, _start, _amount) in enumerate(schedule):
        if kind in ("thread", "soon"):
            assert ends[f"{i}:{kind}:end"] == ends[f"{i}:{kind}:start"]
