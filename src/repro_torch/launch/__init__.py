"""The paged LLM server (serve.py) and the SSM family's single-card
prefill and decode steps (steps.py)."""
