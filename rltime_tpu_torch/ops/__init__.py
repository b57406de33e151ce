"""Ops: returns, losses, the dense PER sampler and the union-gather kernel."""
