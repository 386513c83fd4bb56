"""Multi-tenant serving front: registry, DWRR router, rate limits, SLOs.

Public surface::

    from repro_torch.serve.tenancy import TenantRouter, TenantRegistry, TenantSpec

    router = TenantRouter(cfg, params, hold_ms=2.0)
    router.add_tenant("gold", weight=4.0, priority=1, slo_ms=50.0)
    router.add_tenant("batch", weight=1.0, rate_rps=100.0)
    ticket = router.submit("gold", graph, features)
    response = ticket.result(timeout=5.0)
"""
from repro_torch.serve.tenancy.registry import (
    TenantRegistry,
    TenantSpec,
    TokenBucket,
    UnknownTenant,
)
from repro_torch.serve.tenancy.router import (
    RateLimitExceeded,
    RoutedTicket,
    TenantRouter,
)

__all__ = [
    "RateLimitExceeded",
    "RoutedTicket",
    "TenantRegistry",
    "TenantRouter",
    "TenantSpec",
    "TokenBucket",
    "UnknownTenant",
]
