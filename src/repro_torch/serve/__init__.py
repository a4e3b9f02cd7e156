"""Tune-to-serve: the multi-LoRA serving tier on the shared backbone.

``AdapterPool`` (hot publish/retire into backbone slots) +
``ServingReplica`` (continuous batching over per-lane cache positions,
plus the round-based baseline) + ``ServingFrontend`` (queueing, routing,
§A.3+k2 admission). The cluster lease (``serve/driver.py`` of the JAX
package) comes with the service slice.
"""
from repro_torch.serve.frontend import AdmissionError, ServingFrontend
from repro_torch.serve.pool import (SPEC_VERSION, AdapterPool,
                                    CorruptCheckpoint, PoolFull,
                                    adapter_template)
from repro_torch.serve.replica import (RequestRecord, RoundStats,
                                       ServeRequest, ServingReplica)

__all__ = [
    "AdapterPool", "PoolFull", "CorruptCheckpoint", "SPEC_VERSION",
    "adapter_template", "ServingReplica", "ServeRequest", "RoundStats",
    "RequestRecord", "ServingFrontend", "AdmissionError",
]
