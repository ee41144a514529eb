"""Gateway adapter for the multi-tenant QoS scheduler (the port of
``chunky_bits_tpu/gateway/qos.py``).

The HTTP-shaped half of the QoS plane: tenant resolution from the request
(API key header first, path prefix second, the order
``QosConfig.resolve`` fixes) and the conditional scheduler build the
gateway runs at ``make_app`` time.  The scheduler itself lives in
``cluster/qos.py`` (clock-seam timed, HTTP-free), so it runs unchanged in
virtual time under ``sim.run``.

Zero overhead off: the gateway imports this module only when QoS is on,
and ``maybe_build`` returns None unless the YAML ``qos.enabled`` is true
or (when the YAML leaves it unset) ``$CHUNKY_BITS_TORCH_QOS`` is on.
"""

from __future__ import annotations

from typing import Optional

from chunky_bits_tpu_torch.cluster.qos import QosConfig, QosScheduler

__all__ = ["TENANT_HEADER", "maybe_build", "resolve_request_tenant"]

#: the API-key header tenants authenticate with; resolution falls back to
#: path prefixes, then the ``other`` bucket (closed table: an unknown or
#: rotating key never mints a tenant)
TENANT_HEADER = "X-Api-Key"


def resolve_request_tenant(config: QosConfig, request) -> str:
    """Tenant name for an aiohttp request (total: always a name from the
    closed table)."""
    return config.resolve(request.headers.get(TENANT_HEADER),
                          request.path)


def maybe_build(cluster, *, read_capacity: int,
                write_capacity: int) -> Optional[QosScheduler]:
    """Build the per-worker scheduler iff QoS is on: the YAML
    ``qos.enabled`` wins; absent, the env flag (``tunables.qos_enabled``)
    decides.  Read and write capacities are the gateway's concurrency
    bounds, so QoS on changes who queues, never how much runs."""
    from chunky_bits_tpu_torch.cluster import tunables as _tunables

    config = QosConfig.from_obj(cluster.tunables.qos or {})
    enabled = (config.enabled if config.enabled is not None
               else _tunables.qos_enabled())
    if not enabled:
        return None
    objective_ms = 500.0
    slo_obj = getattr(cluster.tunables, "slo", None)
    if slo_obj:
        # the hedge advisor targets the same read-p99 objective the SLO
        # engine alerts on: one number, two consumers
        objective_ms = float(slo_obj.get("read_p99_ms", 500.0))
    return QosScheduler(
        config,
        read_capacity=read_capacity,
        write_capacity=write_capacity,
        read_p99_objective_ms=objective_ms)
