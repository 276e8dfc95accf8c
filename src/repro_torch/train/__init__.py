"""Serving steps of the port's language models (prefill, decode, greedy
generation)."""
