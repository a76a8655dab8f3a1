"""setup_s: from the process's start to the first timed call: imports,
the corpus made from the seed, the kernels' and host stage's loads (and
their builds, where a checkout has none yet), and the warm-up calls."""


def value(run):
    return run["setup_s"]
