"""Streaming HTTP object gateway (the reference's src/http.rs), plus the
multi-worker serving plane (gateway/workers.py); the port of
``chunky_bits_tpu/gateway``."""

from chunky_bits_tpu_torch.gateway.http import (  # noqa: F401
    HealthState,
    file_ref_etag,
    make_app,
    parse_http_range,
    serve,
)
