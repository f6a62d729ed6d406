"""The authoritative replica roles."""

ROLES = ("prefill", "decode", "unified")
