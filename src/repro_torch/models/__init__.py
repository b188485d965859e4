"""The dense decoder-only transformer (layers.py, transformer.py) behind
the uniform interface of model_zoo.py."""
