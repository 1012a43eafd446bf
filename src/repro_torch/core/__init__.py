"""Spar-Sink numerics on torch tensors: costs, loops, sketches, objectives,
the paper's competitors, and the composite workloads built on `solve`
(the Sinkhorn divergence, fixed-support barycenters, proximal OT)."""
from repro_torch.core.barycenter import ibp, solve_barycenter, spar_ibp
from repro_torch.core.divergence import sinkhorn_divergence, spar_sink_divergence

__all__ = ["ibp", "sinkhorn_divergence", "solve_barycenter", "spar_ibp", "spar_sink_divergence"]
