"""Decoder-only language models (OPT and LLaMA)."""
