"""The paged LLM server (serve.py)."""
