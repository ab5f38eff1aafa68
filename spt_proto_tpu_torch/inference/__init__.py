"""Serving: weights, KV cache, prefill and decode."""
