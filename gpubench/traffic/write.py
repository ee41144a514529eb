"""The ``write`` operation: ``clients`` writers in a closed loop, each
writing objects of ``object_bytes`` through the cluster's own
``FileWriteBuilder`` (its shared encode batcher and host pipeline), to
the void destination when the configuration's ``ingest_store`` is
``void``.  Source bytes are windows of the seeded blob.  A write counts
inside the window when its reference returns there.

Mix parameters: ``clients``, ``warmup`` (objects a writer before the
window), ``blob_bytes``, ``object_bytes`` (else the configuration's) and
``check_per_client`` (parts of each writer's answers the check samples).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gpubench.generator import ClosedLoop, Context, CyclicSource, Window, \
    source_bytes
from gpubench.record import Op, Run
from gpubench.reference import rs


class Traffic:
    kind = "write"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        t, c = ctx.run.traffic, ctx.run.config
        self.obj = int(t.get("object_bytes", c["object_bytes"]))
        self.part_bytes = c["data"] << c["chunk_size_log2"]
        self.want_parts = -(-self.obj // self.part_bytes)
        self.loop = ClosedLoop(int(t["clients"]), int(t["warmup"]))
        writer = ctx.cluster.get_file_writer(ctx.profile)
        if c["ingest_store"] == "void":
            writer = writer.with_destination(None)
        self.writer = writer
        self.base = int(ctx.rng.integers(len(ctx.blob)))
        self.keys = 0
        self._batcher = None

    async def prepare(self) -> None:
        eb = self.writer.encode_batcher
        self._batcher = eb() if callable(eb) else eb

    def start_of(self, key: int) -> int:
        return self.base + key * self.obj

    async def one(self, client: int, win: Window) -> Op:
        key, self.keys = self.keys, self.keys + 1
        src = CyclicSource(self.ctx.blob, self.obj, self.start_of(key))
        op = Op(self.kind, key, self.obj, time.monotonic(), client=client)
        try:
            ref = await self.writer.write(src)
        except Exception as err:  # an answer that never came
            op.answer = err
            return op
        finally:
            self.ctx.spans.add("writer.write", op.t0, time.monotonic())
        op.t1 = time.monotonic()
        op.answer = ref
        op.parts = len(ref.parts)
        op.ok = ref.len_bytes() == self.obj
        if op.ok:
            op.window_bytes = win.count(op.t1, self.obj)
        return op

    async def run(self, win: Window, ops: list) -> None:
        async def step(c, j):
            ops.append(await self.one(c, win))

        await self.loop.run(win, step)

    def counters(self) -> dict:
        b = self._batcher
        return {"encode.dispatches": b.dispatches} if b is not None else {}

    async def close(self) -> None:
        return None

    def sample(self, answered: list[Op]) -> list[tuple[Op, int]]:
        """``check_per_client`` parts of each writer's answers, drawn from
        the seed, and an object's last, shorter part among them."""
        rng = np.random.default_rng(self.ctx.seed + 1)
        per = int(self.ctx.run.traffic["check_per_client"])
        picked = []
        for c in range(self.loop.clients):
            pool = [(op, i) for op in answered if op.client == c
                    for i in range(len(op.answer.parts))]
            n = min(per, len(pool))
            picked += [pool[i] for i in sorted(rng.choice(len(pool), n,
                                                          replace=False))]
        tails = [(op, i) for op in answered
                 for i in range(len(op.answer.parts))
                 if i == self.want_parts - 1]
        if tails and not any(i == self.want_parts - 1 for _, i in picked):
            picked.append(tails[int(rng.integers(len(tails)))])
        return picked

    def compare(self, op: Op, i: int, mat) -> bool:
        """Whether part ``i`` of ``op`` differs from the reference: its
        shard length and the SHA-256 of its d + p rows."""
        cfg = self.ctx.run.config
        lo = i * self.part_bytes
        data = source_bytes(self.ctx.blob, self.start_of(op.key) + lo,
                            min(self.part_bytes, self.obj - lo))
        shard, digests = rs.encode_part(data, cfg["data"], cfg["parity"],
                                        mat)
        part = op.answer.parts[i]
        got = [c.hash.value.digest for c in part.data + part.parity]
        return part.chunksize != shard or got != digests

    def check(self, run: Run) -> dict:
        """Every answer's layout; the sampled parts against the
        reference's shard lengths and SHA-256."""
        cfg = run.config
        mine = run.due(self.kind)
        answered = [op for op in mine if op.t1 is not None]
        layout_bad = sum(1 for op in answered
                         if op.answer.len_bytes() != self.obj
                         or len(op.answer.parts) != self.want_parts)
        picked = self.sample(answered)
        mat = rs.encode_matrix(cfg["data"], cfg["parity"])
        with ThreadPoolExecutor(4) as pool:
            bad = sum(pool.map(lambda x: self.compare(*x, mat), picked))
        return {
            "failed_writes": (len(mine) - len(answered), 0),
            "layout_mismatches": (layout_bad, 0),
            "digest_mismatches": (bad, 0),
            "parts_checked": (len(picked), None),
            "writers_checked": (len({op.client for op, _ in picked}),
                                None),
        }
