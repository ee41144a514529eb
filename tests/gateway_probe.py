"""A client that leaves a gateway right after the last byte of a sendfile
GET, for tests of what the handler leaves behind.

``leave_after_last_sendfile_byte`` takes any gateway ``web.Application``
built with ``sendfile=True`` and serves it under aiohttp's ``TestServer``,
which cancels a handler whose client has gone.  Every thread hop the
handler makes once its sendfile has begun waits for a held thread, so
the client leaves while the handler is either waiting on one or has
ended: a close of the chunk file that needs a thread is then cancelled,
every run.
"""

from __future__ import annotations

import asyncio
import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
from aiohttp import web

#: seconds any one wait of the scenario may take
TIMEOUT = 30


async def leave_after_last_sendfile_byte(app: web.Application,
                                         monkeypatch) -> list:
    """PUT an object through ``app`` under ``TestServer``, GET a range
    inside its first chunk off the sendfile path, and leave right after
    the last byte.  Returns the files the handler sent from, once it
    ended; the caller closes them.  Its own checks fail with
    ``pytest.fail``."""
    from aiohttp.test_utils import TestClient, TestServer

    payload = os.urandom(3 * (1 << 16))
    loop = asyncio.get_running_loop()
    sent_from: list = []
    paused, ended = asyncio.Event(), asyncio.Event()
    gate = threading.Event()
    held = ThreadPoolExecutor(max_workers=1)
    held.submit(gate.wait, TIMEOUT)
    real_sendfile, real_to_thread = loop.sendfile, asyncio.to_thread

    async def sendfile(transport, file, *args, **kwargs):
        sent_from.append(file)
        return await real_sendfile(transport, file, *args, **kwargs)

    async def to_thread(func, /, *args, **kwargs):
        if not sent_from:
            return await real_to_thread(func, *args, **kwargs)
        paused.set()
        return await loop.run_in_executor(
            held, functools.partial(func, *args, **kwargs))

    @web.middleware
    async def note_end(request, handler):
        try:
            return await handler(request)
        finally:
            if sent_from:
                paused.set()
                ended.set()

    app.middlewares.insert(0, note_end)
    monkeypatch.setattr(loop, "sendfile", sendfile)
    monkeypatch.setattr(asyncio, "to_thread", to_thread)
    try:
        async with TestClient(TestServer(app)) as client:
            if (await client.put("/obj/x", data=payload)).status != 200:
                pytest.fail("the PUT failed")
            reader, writer = await asyncio.open_connection(
                client.host, client.port)
            writer.write(b"GET /obj/x HTTP/1.1\r\nHost: gateway\r\n"
                         b"Range: bytes=1000-2999\r\n\r\n")
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), TIMEOUT)
            body = await asyncio.wait_for(reader.readexactly(2000), TIMEOUT)
            if not head.startswith(b"HTTP/1.1 206") or \
                    body != payload[1000:3000]:
                pytest.fail(f"the ranged GET went wrong: {head!r}")
            await asyncio.wait_for(paused.wait(), TIMEOUT)
            writer.close()
            await asyncio.wait_for(ended.wait(), TIMEOUT)
            gate.set()  # held hops run before the server's cleanup
    finally:
        gate.set()
        held.shutdown(wait=True)
    if len(sent_from) != 1:
        pytest.fail(f"the GET sent from {len(sent_from)} files, not 1")
    return sent_from
