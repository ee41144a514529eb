"""``chunky-bits stats [--json] [--watch N] <gateway-url>`` —
one-screen gateway observability summary (the port of
``chunky_bits_tpu/cli/stats.py``).

Fetches the observability surface of a running gateway (``/stats``,
``/healthz``, ``/scrub/status``, ``/alerts`` and — as a grammar check —
``/metrics``) and renders it for a human: request percentiles (computed
server-side by the same ``request_stats``/``percentile`` code in
file/profiler.py that the gateway's access log uses), cache hit rates, pipeline
saturation, per-node health, scrub progress, SLO alert states
(obs/slo.py — firing rules first, with their windowed values against
their objectives), and the event-loop lag histogram's tail
(``obs.metrics.histogram_quantile`` over the scraped buckets).
``--json`` emits the combined raw payloads for machine consumers;
``--watch N`` redraws every N seconds (clock-seam timed, so the one
tool works under a virtual clock too) — a live operator console
without an external scraper.

No reference counterpart (the reference has no metrics surface).  It
renders a gateway of either package: the port's answers the scrub and
SLO stanzas with ``enabled: false``.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, TextIO

from chunky_bits_tpu_torch.errors import ChunkyBitsError
from chunky_bits_tpu_torch.obs import metrics as obs_metrics

#: the clock seam: the --watch redraw cadence follows the active clock
from chunky_bits_tpu_torch.utils import clock as _clock


#: family-by-name lookup — the shared scan in obs/metrics.py
_family = obs_metrics.find_family


def _scalar_total(snapshot: dict, name: str) -> float:
    fam = _family(snapshot, name)
    if fam is None:
        return 0.0
    return sum(s.get("value", 0.0) for s in fam.get("samples", ()))


def render_summary(stats: dict, healthz: dict, scrub: dict,
                   out: TextIO,
                   alerts: Optional[dict] = None) -> None:
    """The one-screen human rendering (pure function of the fetched
    payloads so tests can pin it without a socket)."""
    snap = stats.get("metrics", {"families": []})
    req = stats.get("requests", {})
    print(f"worker {stats.get('worker', '?')} "
          f"status={healthz.get('status', '?')} "
          f"uptime={healthz.get('uptime_s', 0.0):.0f}s", file=out)
    print(f"requests: n={req.get('count', 0)} "
          f"errors={req.get('errors', 0)} "
          f"bytes={req.get('total_bytes', 0)} "
          f"p50={req.get('p50_ms', 0.0):.2f}ms "
          f"p99={req.get('p99_ms', 0.0):.2f}ms "
          f"p999={req.get('p999_ms', 0.0):.2f}ms", file=out)
    dropped = {k: v for k, v in stats.get("dropped", {}).items() if v}
    if dropped:
        print(f"dropped log entries: {dropped}", file=out)
    hits = _scalar_total(snap, "cb_cache_hits_total")
    misses = _scalar_total(snap, "cb_cache_misses_total")
    if hits or misses:
        rate = 100.0 * hits / max(hits + misses, 1.0)
        print(f"cache: hits={hits:.0f} misses={misses:.0f} "
              f"({rate:.1f}% hit) "
              f"bytes={_scalar_total(snap, 'cb_cache_size_bytes'):.0f}/"
              f"{_scalar_total(snap, 'cb_cache_capacity_bytes'):.0f}",
              file=out)
    busy_fam = _family(snap, "cb_pipeline_busy_seconds_total")
    if busy_fam is not None:
        stages = ", ".join(
            f"{s['labels'].get('stage', '?')}={s['value']:.2f}s"
            for s in busy_fam.get("samples", ()))
        print(f"pipeline: threads="
              f"{_scalar_total(snap, 'cb_pipeline_threads'):.0f} "
              f"busy[{stages}] "
              f"idle={_scalar_total(snap, 'cb_pipeline_idle_seconds_total'):.1f}s",
              file=out)
    err_fam = _family(snap, "cb_node_errors_total")
    comp_fam = _family(snap, "cb_node_completions_total")
    if comp_fam is not None:
        errors = {tuple(sorted(s["labels"].items())): s["value"]
                  for s in (err_fam or {}).get("samples", ())}
        for s in comp_fam.get("samples", ()):
            node = s["labels"].get("node", "?")
            err = errors.get(tuple(sorted(s["labels"].items())), 0.0)
            print(f"node {node}: completions={s['value']:.0f} "
                  f"errors={err:.0f}", file=out)
    lag_fam = _family(snap, "cb_eventloop_lag_seconds")
    if lag_fam is not None and lag_fam.get("samples"):
        s = lag_fam["samples"][0]
        p99 = obs_metrics.histogram_quantile(
            lag_fam.get("buckets", []), s.get("counts", []), 99.0)
        print(f"event loop: lag p99~{p99 * 1000.0:.2f}ms "
              f"(n={s.get('count', 0)})", file=out)
    if scrub.get("enabled"):
        print(f"scrub: passes={scrub.get('passes', 0)} "
              f"verified={scrub.get('bytes_verified', 0)}B "
              f"corrupt={scrub.get('corrupt', 0)} "
              f"repaired={scrub.get('repaired', 0)} "
              f"running={scrub.get('running', False)}", file=out)
        repair = scrub.get("repair")
        if repair is not None:
            # the planner's counters (cluster/repair.py RepairStats —
            # the same numbers behind the cb_repair_* families);
            # msr = pm-msr β-projection regenerations (ops/pm_msr.py)
            def helper_bytes(row: dict) -> int:
                return (row.get("helper_bytes_replica", 0)
                        + row.get("helper_bytes_decode", 0)
                        + row.get("helper_bytes_msr", 0))

            helper = helper_bytes(repair)
            ratio = repair.get("helper_bytes_per_rebuilt_byte")
            line = (f"repair: plans copy={repair.get('plans_copy', 0)} "
                    f"decode={repair.get('plans_decode', 0)} "
                    f"msr={repair.get('plans_msr', 0)} "
                    f"fallback={repair.get('plans_fallback', 0)} "
                    f"helperB={helper} "
                    f"rebuiltB={repair.get('bytes_rebuilt', 0)}")
            if ratio is not None:
                line += f" helperB/rebuiltB={ratio:.2f}"
            print(line, file=out)
            by_code = repair.get("by_code") or {}
            active = {c: v for c, v in sorted(by_code.items())
                      if any(v.get(k, 0) for k in v)}
            if len(active) > 1 or (active and "rs" not in active):
                for code_name, v in active.items():
                    print(f"repair[{code_name}]: "
                          f"helperB={helper_bytes(v)} "
                          f"rebuiltB={v.get('bytes_rebuilt', 0)}",
                          file=out)
    else:
        print("scrub: disabled", file=out)
    alerts = alerts if alerts is not None else {"enabled": False}
    if not alerts.get("enabled"):
        print("slo: disabled", file=out)
    else:
        firing = alerts.get("firing", [])
        fleet = alerts.get("fleet") or {}
        fleet_firing = fleet.get("firing", [])
        header = (f"slo: {len(firing)} firing "
                  f"(evals={alerts.get('evaluations', 0)})")
        if fleet:
            header += f" fleet-firing={len(fleet_firing)}"
        print(header, file=out)
        # firing rules first (the operator's first question), then
        # pending; quiet rules stay off the screen
        rows = sorted(alerts.get("alerts", ()),
                      key=lambda a: (a.get("state") != "firing",
                                     a.get("state") != "pending",
                                     a.get("rule", "")))
        for a in rows:
            if a.get("state") == "inactive":
                continue
            fast = a.get("value_fast")
            fast_s = "-" if fast is None else f"{fast:.4g}"
            print(f"  alert {a.get('rule')}: {a.get('state')} "
                  f"value={fast_s} threshold={a.get('threshold')} "
                  f"fired_count={a.get('fired_count', 0)}", file=out)


async def fetch_once(base: str) -> tuple[dict, dict, dict, dict]:
    """One round of the gateway's observability surface:
    (stats, healthz, scrub, alerts) — with the /metrics exposition
    grammar gate riding along (the same parser the tests and CI scrape
    step use).  Raises ChunkyBitsError on an unreachable or defective
    gateway — a stats tool must not silently summarize garbage."""
    import aiohttp

    try:
        async with aiohttp.ClientSession() as session:
            async with session.get(f"{base}/stats") as resp:
                if resp.status != 200:
                    raise ChunkyBitsError(
                        f"GET /stats returned {resp.status}")
                stats = await resp.json()
            async with session.get(f"{base}/healthz") as resp:
                healthz = await resp.json()
            async with session.get(f"{base}/scrub/status") as resp:
                scrub = await resp.json()
            async with session.get(f"{base}/alerts") as resp:
                if resp.status == 200:
                    alerts = await resp.json()
                else:
                    # a pre-SLO gateway 404s here (the catch-all
                    # treats "alerts" as an object name): render the
                    # rest of the stats surface with the slo stanza
                    # disabled instead of failing the whole command —
                    # mixed-version fleets are a normal rollout state
                    alerts = {"enabled": False}
            async with session.get(f"{base}/metrics") as resp:
                metrics_text = await resp.text()
    except aiohttp.ClientError as err:
        raise ChunkyBitsError(f"cannot reach gateway {base}: {err}") \
            from err
    try:
        obs_metrics.parse_exposition(metrics_text)
    except obs_metrics.ExpositionError as err:
        # surfaced as the CLI's one-line error, not a traceback: a
        # proxy answering /metrics with HTML is an operator problem to
        # report, not a crash
        raise ChunkyBitsError(
            f"{base}/metrics is not valid exposition: {err}") from err
    return stats, healthz, scrub, alerts


async def stats_command(url: str, as_json: bool,
                        out: Optional[TextIO] = None,
                        watch_s: float = 0.0) -> int:
    """Fetch + render; the ``chunky-bits stats`` body.  ``watch_s`` > 0
    loops forever, redrawing every that-many seconds (timed through the
    clock seam) with a timestamped separator between frames — the live
    operator console for the alert/SLO stanza.  Ctrl-C exits the loop
    cleanly (the CLI's standard 130)."""
    out = out if out is not None else sys.stdout
    base = url.rstrip("/")
    if "://" not in base:
        base = f"http://{base}"
    frame = 0
    while True:
        stats, healthz, scrub, alerts = await fetch_once(base)
        if as_json:
            json.dump({"stats": stats, "healthz": healthz,
                       "scrub": scrub, "alerts": alerts},
                      out, indent=2)
            print(file=out)
        else:
            if watch_s > 0:
                print(f"--- frame {frame} "
                      f"(every {watch_s:g}s, ctrl-c to stop) ---",
                      file=out)
            render_summary(stats, healthz, scrub, out, alerts=alerts)
        if watch_s <= 0:
            return 0
        frame += 1
        out.flush()
        await _clock.sleep(watch_s)
