"""setup_s: seconds from the start of the process to the opening of the
window: imports, the kernel library's build or load, the tables, the
pool's load and the warm-up."""


def read(run):
    return run.setup_s
