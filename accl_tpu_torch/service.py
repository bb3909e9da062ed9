"""Tenant labels: the port's copy of ``validate_tenant`` and
``tenant_label`` from ``accl_tpu/service/admission.py``.

A tenant groups a driver's communicators for attribution: the
``tenant`` label of the call-accounting rows, :class:`~accl_tpu_torch.
tracing.CallRecord` ``tenant`` and the trace's tenant tracks. The
reference's admission controller, quotas and rank service belong to its
emulated fabric and are not ported (ROADMAP §A, "Not queued")."""

from __future__ import annotations

import re

__all__ = ["tenant_label", "validate_tenant"]

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def validate_tenant(name: str) -> str:
    """Restrict an explicit tenant label to a safe charset: it is spliced
    verbatim into CSV rows, Prometheus label values, trace track names and
    log lines, where a comma, quote or newline would corrupt them.
    Raises ValueError; returns the name."""
    if not _TENANT_RE.match(name):
        raise ValueError(
            f"invalid tenant label {name!r}: must match "
            "[A-Za-z0-9][A-Za-z0-9._-]{0,63} (it is embedded in CSV, "
            "Prometheus and trace encodings)")
    return name


def tenant_label(comm_id: int, mapping: dict | None = None) -> str:
    """The tenant a communicator belongs to: the explicit grouping when
    one was configured (``ACCL(tenant=...)``), else the communicator is
    its own tenant."""
    if mapping:
        t = mapping.get(comm_id)
        if t:
            return t
    return f"comm-{comm_id}"
