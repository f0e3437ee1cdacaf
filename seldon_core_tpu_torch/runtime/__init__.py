"""Serving runtime: paged KV cache, LLM engine, components."""
