"""The dense decoder-only transformer (layers.py, transformer.py) and
the pure-SSM LM (mamba2.py, ssm_lm.py) behind the uniform interface of
model_zoo.py."""
