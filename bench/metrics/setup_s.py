"""setup_s: from the process's start to the first measured step or call
(imports, kernel builds, weights and inputs made from the seed, warm-up)."""


def read(run):
    return run["setup_s"]
