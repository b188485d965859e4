"""The launch side: the paged LLM server (serve.py), the step functions and
their builders (steps.py), training's loop (train.py) and elastic restore
(elastic.py), meshes (mesh.py), and the dry run (dryrun.py) with its op
analysis (op_analysis.py)."""
