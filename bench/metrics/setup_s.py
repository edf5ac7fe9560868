"""``setup_s``: from the start of the command's process to the first timed
request: imports, CUDA start, kernel libraries loaded from the build
directory (built there by a checkout's first run), data drawn on the
card, indexes, probe cache and warm-up."""


def read(run):
    return run.setup_s
