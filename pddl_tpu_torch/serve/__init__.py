"""Paged serving: engine, scheduler, requests, metrics, KV cache."""
