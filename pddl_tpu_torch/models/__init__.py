"""Model families of the port (Llama; the sampling hooks in gpt.py)."""
