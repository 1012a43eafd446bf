"""Spar-Sink numerics on torch tensors: costs, loops, sketches, objectives and the paper's competitors."""
