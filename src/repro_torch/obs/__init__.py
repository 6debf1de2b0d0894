from repro_torch.obs.audit import ContractAuditor
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry)

__all__ = ["ContractAuditor", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "default_registry"]
