"""Tensor ops: PQ math, tile selection, oracles and kernel wrappers."""
